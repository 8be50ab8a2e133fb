"""The denoiser UNet, its blocks and the condition encoder; the seg UNet
and the MNIST classifier.

The exports of `localdiffusion_tpu/models/__init__.py`, but one: its
function `encode_cond(params, cfg, cond)` is the method
`UNet.encode_cond(cond)` here (and `GaussianDiffusion.encode_cond`), the
weights being the module's own.
"""

from localdiffusion_tpu_torch.models.blocks import (  # noqa: F401
    Attention,
    Block,
    Downsample,
    LinearAttention,
    ResnetBlock,
    RMSNorm,
    SinusoidalPosEmb,
    TimeMlp,
    Upsample,
)
from localdiffusion_tpu_torch.models.cond_encoder import BasicBlock, CondEncoder  # noqa: F401
from localdiffusion_tpu_torch.models.seg_unet import (  # noqa: F401
    SegUNet,
    bce_dice_loss,
    dice_loss,
)
from localdiffusion_tpu_torch.models.simple_cnn import SimpleCNN  # noqa: F401
from localdiffusion_tpu_torch.models.unet import UNet  # noqa: F401
