"""localdiffusion_tpu_torch: the PyTorch/CUDA port of localdiffusion_tpu.

The JAX package `localdiffusion_tpu` is the reference; this package imports
nothing of it, nor JAX, nor YAML but where a YAML file is read
(`config.load_config`).  Every Pallas kernel of the JAX package is a CUDA
C++ kernel in `csrc/`, built and launched only when a CUDA tensor reaches
its wrapper (a CPU tensor takes the kernel's plain PyTorch version).  It
ports the whole JAX package but its TPU layouts:

  * inference: `InferenceServer` (`serving`, `scripts.serve`) →
    `pipeline.translate` / `run` / `translate_volume` → Stage A (`ood/`:
    PatchCore over the WRN50-2's, the seg encoder's or the denoiser's taps,
    the seg detector, the manual and none masks, the classifier gate) →
    the plain and branched DDPM and DDIM samplers (`diffusion/`) → the
    UNet (`models/`) and its kernels (`ops/`), built by `factory`;
  * across ranks (`parallel/`): a pipeline and a server over a
    ('data', 'patch') mesh, patch-parallel sampling, data-parallel and
    FSDP training, on `torch.distributed`;
  * training: `GaussianDiffusion.loss`, `train.trainer.Trainer` and
    `scripts.train`, the kernels differentiable through their autograd
    Functions (`ops/autograd.py`);
  * data: the readers, the synthetic sets and the streaming loader
    (`data/`); configurations from builders, `.json` or `.yaml` files
    (`config`); the command-line entry points in `scripts/`.

The names below are the JAX package's top-level exports, and `load_config`.
"""

__version__ = "0.1.0"

from localdiffusion_tpu_torch.config import (  # noqa: F401
    Config,
    DataConfig,
    DiffusionConfig,
    MeshConfig,
    ModelConfig,
    OODConfig,
    SamplerConfig,
    TrainConfig,
    load_config,
    load_reference_yaml,
)
