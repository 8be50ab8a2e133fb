"""Stage A: PatchCore over the WRN50-2's, the seg encoder's or the
denoiser's taps, the threshold ladders and masks, the front end, the
classifier gate and the memory-bank build (`ood.bank`).

The exports of `localdiffusion_tpu/ood/__init__.py`, but one: its
`convert_torch_state_dict` (a torchvision WRN50-2 state dict into the flax
tree) has `wide_resnet.load_torchvision_state_dict` as its counterpart,
which loads the state dict into the port's own module.
"""

from localdiffusion_tpu_torch.ood.classifier import (  # noqa: F401
    ClassifierPatchCore,
    preprocess_for_patchcore,
    roc_optimal_threshold,
)
from localdiffusion_tpu_torch.ood.frontend import OODFrontend  # noqa: F401
from localdiffusion_tpu_torch.ood.patchcore import (  # noqa: F401
    PatchCore,
    anomaly_map_from_scores,
    compute_anomaly_score,
    euclidean_dist,
    generate_embedding,
    kcenter_greedy_indices,
    nearest_neighbors,
    subsample_embedding,
)
from localdiffusion_tpu_torch.ood.thresholds import (  # noqa: F401
    LADDERS,
    ThresholdLadder,
    ladder_for,
    manual_mask,
    soft_mask_from_map,
)
from localdiffusion_tpu_torch.ood.wide_resnet import (  # noqa: F401
    WideResNet50Features,
    load_torchvision_state_dict,
)
