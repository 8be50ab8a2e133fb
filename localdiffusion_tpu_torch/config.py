"""Immutable configuration for the PyTorch port.

A copy of the dataclasses the Stage-B serving path reads from
`localdiffusion_tpu/config.py` (ModelConfig, DiffusionConfig, SamplerConfig,
OODConfig, DataConfig, TrainConfig, Config, min_max_val_for).  The port keeps
its own copy because it imports nothing of the JAX package, and that module
imports `yaml`, which a CUDA host need not have.  The flagship configuration
(`configs/mnist.yaml`) is built in Python by `flagship_config()`, the 256px
MRI one (`configs/mri_synthetic_256.yaml`) by `mri256_config()`, and its
s2d-stem variant (`configs/mri_synthetic_256_stem.yaml`) by
`stem256_config()`; `Config.from_dict` takes the parsed contents of such a
file.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Denoiser UNet + condition-encoder hyperparameters."""

    dim: int = 32
    init_dim: Optional[int] = None
    out_dim: Optional[int] = None
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 1
    cond_channels: Optional[int] = None  # defaults to `channels`
    resnet_block_groups: int = 8
    attn_heads: int = 4
    attn_dim_head: int = 32
    full_attn: Tuple[bool, ...] = (False, False, False, True)
    # 'shallow' = 3 encoder blocks, 'deep' = 4, 'auto' = one per UNet stage
    cond_encoder_depth: str = "auto"
    cond_group_num: int = 16
    time_emb_theta: int = 10000
    self_condition: bool = False
    learned_sinusoidal_cond: bool = False
    random_fourier_features: bool = False
    learned_sinusoidal_dim: int = 16
    stem_space_to_depth: int = 1
    # TPU lane-layout execution of the same network; read by the JAX package
    # only (the port always runs the standard layout).
    exact_layout_s2d: int = 0
    exact_layout_s2d_stages: int = 0

    def __post_init__(self):
        if len(self.full_attn) != len(self.dim_mults):
            raise ValueError(
                f"full_attn {self.full_attn} must match dim_mults {self.dim_mults}"
            )
        if self.cond_encoder_depth not in ("shallow", "deep", "auto"):
            raise ValueError(f"bad cond_encoder_depth {self.cond_encoder_depth}")

    @property
    def resolved_init_dim(self) -> int:
        return self.init_dim if self.init_dim is not None else self.dim

    @property
    def resolved_out_dim(self) -> int:
        return self.out_dim if self.out_dim is not None else self.channels

    @property
    def resolved_cond_channels(self) -> int:
        return self.cond_channels if self.cond_channels is not None else self.channels

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.dim_mults) - 1)

    @property
    def cond_num_blocks(self) -> int:
        extra = max(0, (self.stem_space_to_depth - 1).bit_length())
        if self.cond_encoder_depth == "shallow":
            return 3 + extra
        if self.cond_encoder_depth == "deep":
            return 4 + extra
        return len(self.dim_mults) + extra

    @property
    def cond_base_dim(self) -> int:
        return 32 if self.dim >= 32 else self.dim


@dataclass(frozen=True)
class DiffusionConfig:
    """Gaussian diffusion process hyperparameters."""

    image_size: int = 28
    timesteps: int = 250
    sampling_timesteps: Optional[int] = None  # < timesteps → DDIM
    objective: str = "pred_x0"  # pred_noise | pred_x0 | pred_v
    beta_schedule: str = "sigmoid"  # linear | cosine | sigmoid
    ddim_sampling_eta: float = 0.0
    auto_normalize: bool = False
    offset_noise_strength: float = 0.0
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0

    def __post_init__(self):
        if self.objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {self.objective}")
        if self.beta_schedule not in ("linear", "cosine", "sigmoid"):
            raise ValueError(f"unknown beta schedule {self.beta_schedule}")
        if self.sampling_timesteps is not None and self.sampling_timesteps > self.timesteps:
            raise ValueError("sampling_timesteps must be <= timesteps")

    @property
    def resolved_sampling_timesteps(self) -> int:
        return (
            self.sampling_timesteps
            if self.sampling_timesteps is not None
            else self.timesteps
        )

    @property
    def is_ddim_sampling(self) -> bool:
        return self.resolved_sampling_timesteps < self.timesteps


@dataclass(frozen=True)
class SamplerConfig:
    """Static switches of the local-diffusion sampler."""

    branch_out: bool = True
    start_intermediate: bool = True
    start_timestep: int = 2  # fusion point: fuse when t <= start_timestep
    use_gt: bool = False
    use_gt_timestep: int = 100
    mask_cond: bool = False
    mask_x: bool = True
    mask_x_policy: str = "cond"  # cond | minval
    cond_in_floor: float = 0.5
    classifier: bool = False
    classifier_obj: str = "tile"
    classifier_polarity: str = "preserve"  # preserve | suppress
    ood_ad: bool = True
    ood_confidence: bool = False
    return_all_timesteps: bool = False
    fusion_route: str = "zero_sentinel"  # zero_sentinel | mask
    max_classifier_retries: int = 0

    def __post_init__(self):
        if self.mask_x_policy not in ("cond", "minval"):
            raise ValueError(f"bad mask_x_policy {self.mask_x_policy}")
        if self.classifier_polarity not in ("preserve", "suppress"):
            raise ValueError(f"bad classifier_polarity {self.classifier_polarity}")
        if self.fusion_route not in ("zero_sentinel", "mask"):
            raise ValueError(f"bad fusion_route {self.fusion_route}")


@dataclass(frozen=True)
class OODConfig:
    """Stage-A options.  The port serves the 'patchcore' detector over the
    denoiser's own taps (`feature_source='denoiser'`), 'manual' and 'none';
    the WRN and seg-encoder sources and the 'seg' detector raise.  Every
    field is kept so a configuration file reads unchanged."""

    detector: str = "patchcore"  # patchcore | seg | manual | none
    backbone: str = "wide_resnet50_2"
    layers: Tuple[str, ...] = ("layer2", "layer3")
    feature_source: str = "wrn"
    feature_layers: Tuple[str, ...] = ()
    feature_npz: Optional[str] = None
    feature_t: Any = 5
    input_size: int = 224
    num_neighbors: int = 9
    coreset_ratio: float = 0.1
    memory_bank_path: Optional[str] = None
    ladder_path: Optional[str] = None
    backbone_weights_path: Optional[str] = None
    seg_model_path: Optional[str] = None
    classifier_threshold: Optional[float] = None
    manual_mask_cols: int = 7
    mask_dilate: int = 0
    mask_refine: str = "none"
    refine_seed: str = "fwhm"
    refine_hi_frac: float = 0.5
    refine_lo_frac: float = 0.25
    refine_min_area: int = 0

    def resolved_mask_dilate(self, strides: Dict[str, int]) -> int:
        """Dilation radius in output pixels; -1 (auto) resolves to one
        feature cell of the coarsest tap, from the feature source's own
        `strides` (which know the denoiser's stem factor).  The port's one
        source, the denoiser, sees the image at its own resolution, so a
        stride is in output pixels."""
        if self.mask_dilate >= 0:
            return self.mask_dilate
        layers = self.feature_layers or ("down2_block2", "down3_block2")
        return max(1, int(max(strides[l] for l in layers)))

    def __post_init__(self):
        if self.detector not in ("patchcore", "seg", "manual", "none"):
            raise ValueError(f"unknown ood detector {self.detector}")
        if self.feature_source not in ("wrn", "seg_encoder", "denoiser"):
            raise ValueError(f"unknown feature_source {self.feature_source}")
        if self.mask_dilate < -1:
            raise ValueError("mask_dilate must be >= 0, or -1 for auto")
        if self.mask_refine not in ("none", "hysteresis"):
            raise ValueError(f"unknown mask_refine {self.mask_refine}")
        if self.refine_seed not in ("ladder", "fwhm"):
            raise ValueError(f"unknown refine_seed {self.refine_seed}")
        if not 0.0 < self.refine_lo_frac <= self.refine_hi_frac <= 1.0:
            raise ValueError("need 0 < refine_lo_frac <= refine_hi_frac <= 1")


@dataclass(frozen=True)
class DataConfig:
    """Dataset name and the normalization statistics `min_max_val_for` reads."""

    name: str = "mnist"
    mnist_path: str = "./MNIST/raw/train-images-idx3-ubyte"
    mnist_labels_path: str = "./MNIST/raw/train-labels-idx1-ubyte"
    mri_files: str = ""
    mvtec_path: str = ""
    mnist_cls: str = "8to3"
    anomaly_name: Any = 3
    augmentations: bool = False
    translate_zero: bool = True
    mean_t1: float = 610.7180906353575
    std_t1: float = 1018.7631901605115
    mean_flair: float = 221.69656048399028
    std_flair: float = 386.31912016662903
    mean_t2: float = 426.0168
    std_t2: float = 771.2276
    mean_mnist: float = 33.31842
    std_mnist: float = 78.5679


@dataclass(frozen=True)
class TrainConfig:
    """Training options; the port's inference path reads `compute_dtype`."""

    batch_size: int = 64
    lr: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    num_steps: int = 100000
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    save_and_sample_every: int = 500
    results_dir: str = "./results"
    project_name: str = "mnist"
    step_mode: str = "epoch"
    compute_dtype: str = "float32"
    seed: int = 42


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    ood: OODConfig = field(default_factory=OODConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Config":
        def build(cls, sub):
            names = {f.name for f in dataclasses.fields(cls)}
            kw = {k: v for k, v in dict(sub or {}).items() if k in names}
            for k, v in kw.items():
                if isinstance(v, list):
                    kw[k] = tuple(v)
            return cls(**kw)

        return Config(
            model=build(ModelConfig, d.get("model")),
            diffusion=build(DiffusionConfig, d.get("diffusion")),
            sampler=build(SamplerConfig, d.get("sampler")),
            ood=build(OODConfig, d.get("ood")),
            data=build(DataConfig, d.get("data")),
            train=build(TrainConfig, d.get("train")),
        )


def flagship_config() -> Config:
    """`configs/mnist.yaml`, the 28px flagship, built without YAML."""
    return Config(
        model=ModelConfig(
            dim=32, init_dim=32, dim_mults=(1, 2, 4),
            full_attn=(False, False, True), channels=1,
            cond_encoder_depth="shallow",
        ),
        diffusion=DiffusionConfig(
            image_size=28, timesteps=50, sampling_timesteps=None,
            objective="pred_x0", beta_schedule="sigmoid",
        ),
        sampler=SamplerConfig(
            branch_out=True, start_intermediate=True, start_timestep=2,
            mask_x=True, mask_x_policy="cond", cond_in_floor=0.5,
            ood_ad=True, classifier=False,
        ),
        ood=OODConfig(
            detector="manual", input_size=84,
            memory_bank_path="results/memory_bank_mnist.npy",
            layers=("layer1", "layer2"), num_neighbors=9, coreset_ratio=0.1,
            manual_mask_cols=7, mask_dilate=5,
        ),
        data=DataConfig(name="mnist", mnist_cls="8to3", anomaly_name=3),
        train=TrainConfig(results_dir="./results", project_name="mnist_x250"),
    )


def mri256_config() -> Config:
    """`configs/mri_synthetic_256.yaml`, the 256px MRI chain, built without
    YAML: 4-stage UNet (dim 32, mults 1/2/4/8), deep condition encoder,
    T=250 ancestral DDPM, minval mask_x, cond_in floor 0.95, bf16 compute."""
    return Config(
        model=ModelConfig(
            dim=32, init_dim=32, dim_mults=(1, 2, 4, 8),
            full_attn=(False, False, False, True), channels=1,
            cond_encoder_depth="deep",
        ),
        diffusion=DiffusionConfig(
            image_size=256, timesteps=250, sampling_timesteps=250,
            objective="pred_x0", beta_schedule="sigmoid",
        ),
        sampler=SamplerConfig(
            branch_out=True, start_intermediate=True, start_timestep=2,
            mask_x=True, mask_x_policy="minval", cond_in_floor=0.95, ood_ad=True,
        ),
        ood=OODConfig(
            detector="patchcore", feature_source="denoiser",
            feature_npz="results/mri_synth256_ema.npz", feature_t=5,
            input_size=256, mask_refine="hysteresis", refine_seed="fwhm",
            refine_lo_frac=0.45, mask_dilate=8,
            memory_bank_path="results/memory_bank_mri256_denoiser.npy",
            layers=("layer2", "layer3"),
        ),
        data=DataConfig(
            name="synthetic_brain", translate_zero=True, mean_t1=300.0,
            std_t1=350.0, mean_flair=250.0, std_flair=280.0,
        ),
        train=TrainConfig(
            batch_size=8, lr=1e-4, num_steps=400, results_dir="./results",
            project_name="mri_synth256", compute_dtype="bfloat16",
        ),
    )


def stem256_config() -> Config:
    """`configs/mri_synthetic_256_stem.yaml`, the README's recommended 256px
    deployment, built without YAML: the 256px UNet with a space-to-depth ×2
    stem (the network runs at 128² and the condition encoder gains a
    block), DDIM-50, the plain chain (`detector: none`), float32 compute."""
    base = mri256_config()
    return Config(
        model=dataclasses.replace(base.model, stem_space_to_depth=2),
        diffusion=dataclasses.replace(base.diffusion, sampling_timesteps=50),
        sampler=base.sampler,
        ood=OODConfig(
            detector="none", input_size=256,
            memory_bank_path="results/memory_bank_synthetic_brain_256.npy",
            layers=("layer2", "layer3"),
        ),
        data=base.data,
        train=TrainConfig(
            batch_size=8, lr=1e-4, num_steps=400, results_dir="./results",
            project_name="mri_stem256",
        ),
    )


def min_max_val_for(config: Config) -> Tuple[float, float]:
    """Value range x_start is clipped to during sampling."""
    name = config.data.name
    if name in ("mri", "synthetic_brain"):
        d = config.data
        if not d.translate_zero:
            max_val = (4096.0 - d.mean_flair) / d.std_flair
            min_val = (0.0 - d.mean_flair) / d.std_flair
            return (min_val, max_val)
        min_val2 = (0.0 - d.mean_flair) / d.std_flair
        max_val = (4096.0 - d.mean_flair) / d.std_flair + abs(min_val2)
        return (0.0, max_val)
    return (0.0, 2.0)
