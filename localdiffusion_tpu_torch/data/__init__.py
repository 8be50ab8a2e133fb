"""The data readers, the synthetic data and the streaming loader (numpy;
PIL where an image file is decoded): the exports of
`localdiffusion_tpu/data/__init__.py`."""

from localdiffusion_tpu_torch.data.loader import ArrayLoader, cycle  # noqa: F401
from localdiffusion_tpu_torch.data.stream import (  # noqa: F401
    StreamLoader,
    device_prefetch,
    npy_shard,
)
from localdiffusion_tpu_torch.data.mnist import (  # noqa: F401
    MNISTDataset,
    degrade,
    load_mnist_arrays,
    read_idx,
)
from localdiffusion_tpu_torch.data.brats import (  # noqa: F401
    BRATSPngDataset,
    BRATSSegDataset,
    BRATSVolumeDataset,
)
from localdiffusion_tpu_torch.data.mvtec import (  # noqa: F401
    MvtecDatasetSR,
    salt_and_pepper,
    sr_degrade,
)
from localdiffusion_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_brain_pair,
    synthetic_brain_translation,
    synthetic_digits,
)
from localdiffusion_tpu_torch.data.folder import ImageFolderDataset  # noqa: F401
