"""Immutable configuration for the PyTorch port.

A copy of `localdiffusion_tpu/config.py` (ModelConfig, DiffusionConfig,
SamplerConfig, OODConfig, DataConfig, TrainConfig, MeshConfig, Config with
`to_dict`, `from_dict` and its YAML I/O, `reference_dict_to_config`,
`load_reference_yaml`, min_max_val_for).  The port keeps its own copy
because it imports nothing of the JAX package, and that module imports
`yaml` at its top, which a CUDA host need not have.  The flagship configuration
(`configs/mnist.yaml`) is built in Python by `flagship_config()`, the 256px
MRI one (`configs/mri_synthetic_256.yaml`) by `mri256_config()`, its
classifier-gated variant (`configs/mri_synthetic_256_gated.yaml`) by
`mri256_gated_config()`, its s2d-stem variant
(`configs/mri_synthetic_256_stem.yaml`) by `stem256_config()`, its bf16
DDIM variant with the seg detector (`configs/mri_synthetic_256_bf16.yaml`)
by `mri256_bf16_config()`, and the 64px MRI flow
(`configs/mri_synthetic.yaml`) by `mri64_config()`, the MNIST training and
test files (`configs/mnist_train.yaml`, `mnist_8to5.yaml`,
`mnist_gated.yaml`, `mnist_usegt.yaml`) and the MVTec-style pair
(`configs/mvtec_synthetic.yaml`, `mvtec_denoise.yaml`) by their
`*_config()` builders;
`load_config` takes a builder's name (`CONFIGS`), a `.json` path (a
`Config.to_dict` dump, or the reference's flat key set through
`reference_dict_to_config`) or a `.yaml`/`.yml` path of either form, the
counterpart of the JAX `scripts/train.py::load_config`.  YAML is read
through PyYAML, imported only where a YAML file is read or written: the
card's machine has no PyYAML, and a `.json` dump (`Config.save_json`) is
the form it reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
    """Stage-A options: the 'patchcore' detector over the WRN50-2, the
    seg encoder's or the denoiser's taps (`feature_source`), the 'seg'
    detector (a SegUNet's sigmoid at 0.5), 'manual' and 'none'.  Every
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

    # each WRN50-2 tap's feature stride (ood/wide_resnet.py)
    _LAYER_STRIDE = {"layer1": 4, "layer2": 8, "layer3": 16, "layer4": 32}

    def _stride_of(self, layer: str) -> int:
        """A tap's feature stride from its name alone, for any source: WRN
        layerN, seg-encoder inc/downN, denoiser downN_blockM (which cannot
        see a space-to-depth stem: pass the source's own `strides`)."""
        if layer in self._LAYER_STRIDE:
            return self._LAYER_STRIDE[layer]
        if layer == "inc":
            return 1
        if layer.startswith("down") and layer[4:5].isdigit():
            return 2 ** int(layer[4])
        return 8

    def resolved_mask_dilate(self, image_size: int, strides: Optional[Dict[str, int]] = None) -> int:
        """Dilation radius in output pixels; -1 (auto) resolves to 0 off the
        'patchcore' detector, else to one feature cell of the coarsest tap:
        from the source's own `strides` where given (they know the
        denoiser's stem factor), else from the tap names.  The WRN sees the
        image resized to `input_size`, so its stride is rescaled by
        image_size / input_size; the raw sources (seg encoder, denoiser) see
        it at its own size, so their stride is in output pixels."""
        if self.mask_dilate >= 0:
            return self.mask_dilate
        if self.detector != "patchcore":
            return 0
        layers = self.feature_layers or {
            "wrn": self.layers,
            "seg_encoder": ("down2", "down3"),
            "denoiser": ("down2_block2", "down3_block2"),
        }[self.feature_source]
        stride = max((strides or {}).get(l, self._stride_of(l)) for l in layers)
        if self.feature_source == "wrn":
            return max(1, round(stride * image_size / self.input_size))
        return max(1, int(stride))

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
    """Training options (`train.trainer`, `scripts.train`); the inference
    path reads `compute_dtype`.  `step_mode` is the JAX file's field
    ('epoch' or 'batch'); `scripts.train --step-mode` chooses the step,
    'resident' included, as the JAX script does."""

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

    def __post_init__(self):
        if self.step_mode not in ("epoch", "batch"):
            raise ValueError(f"bad step_mode {self.step_mode}")


@dataclass(frozen=True)
class MeshConfig:
    """The ('data', 'patch') mesh over ranks (`parallel.mesh.make_mesh`):
    data - the batch split over ranks (-1: every rank not on 'patch');
    patch - the branch pair and the patches split over ranks."""

    data_axis: int = -1
    patch_axis: int = 1


def _yaml():
    """PyYAML, imported where a YAML file is read or written."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading or writing a YAML configuration needs PyYAML, which is not "
                          "installed: pass a builder name or a .json dump (Config.save_json) "
                          "instead") from e
    return yaml


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    ood: OODConfig = field(default_factory=OODConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    def save_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            _yaml().safe_dump(self.to_dict(), f, sort_keys=False)

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
            mesh=build(MeshConfig, d.get("mesh")),
        )

    @staticmethod
    def load_yaml(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(_yaml().safe_load(f))


# the reference entry scripts' per-dataset UNet presets
_DATASET_MODEL_PRESETS = {
    "mnist": dict(dim_mults=(1, 2, 4), full_attn=(False, False, True), channels=1,
                  cond_encoder_depth="shallow"),
    "mri": dict(dim_mults=(1, 2, 4, 8), full_attn=(False, False, False, True), channels=1,
                cond_encoder_depth="deep"),
    "mvtec": dict(dim_mults=(1, 2, 4, 8), full_attn=(False, False, False, True), channels=3,
                  cond_encoder_depth="deep"),
    "mvtecSR": dict(dim_mults=(1, 2, 4), full_attn=(False, False, True), channels=3,
                    cond_encoder_depth="shallow"),
}


def load_reference_yaml(path: str) -> Config:
    """A reference-format flat YAML (its config.yaml / config_train.yaml)
    as a Config (`reference_dict_to_config`)."""
    with open(path) as f:
        return reference_dict_to_config(_yaml().safe_load(f))


def reference_dict_to_config(raw: Mapping[str, Any]) -> Config:
    """The reference's flat key set mapped onto the structured Config, with
    the per-dataset presets its entry scripts hard-code."""
    g = raw.get
    data_name = g("data", "mnist")
    preset = dict(_DATASET_MODEL_PRESETS.get(data_name, {}))
    model = ModelConfig(dim=g("dim", 32), init_dim=g("dim", 32), **preset)

    ddim = g("ddim_timestep", None)
    if ddim in (False, 0):
        ddim = None
    timesteps = g("timestep", 250)
    if ddim is not None and ddim >= timesteps:
        ddim = None  # as many steps as trained: ancestral sampling
    diffusion = DiffusionConfig(
        image_size=g("img_size", 28), timesteps=timesteps, sampling_timesteps=ddim,
        objective=g("pred_objective", "pred_x0"), beta_schedule=g("scheduler", "sigmoid"),
        auto_normalize=False,
    )
    sampler = SamplerConfig(
        branch_out=g("branch_out", True),
        start_intermediate=g("start_intermediate", True),
        start_timestep=g("start_timestep", 2),
        use_gt=g("use_gt", False),
        use_gt_timestep=g("use_gt_timestep", 100),
        mask_cond=g("mask_cond", False),
        mask_x=g("mask_x", True),
        mask_x_policy="minval" if "mri" in str(data_name) else "cond",
        cond_in_floor=0.5 if data_name == "mnist" else 0.95,
        classifier=g("classifier", False),
        classifier_obj=g("classifier_obj", "tile"),
        classifier_polarity=g("classifier_polarity", "preserve"),
        ood_ad=g("ood_AD", True),
        ood_confidence=g("ood_confidence", False),
        return_all_timesteps=g("return_all_timesteps", False),
    )
    ood_block = g("ood_detector", {}) or {}
    ood = OODConfig(
        detector="seg" if ood_block.get("seg", False) else "patchcore",
        input_size=84 if data_name == "mnist" else 224,
        seg_model_path=ood_block.get("seg_model"),
    )
    data = DataConfig(
        name=data_name,
        mnist_path=g("mnist_path", "./MNIST/raw/train-images-idx3-ubyte"),
        mnist_labels_path=g("mnist_labels_path", "./MNIST/raw/train-labels-idx1-ubyte"),
        mri_files=g("mri_files", ""),
        mvtec_path=g("mvtec_path", ""),
        mnist_cls=g("mnist_cls", "8to3"),
        anomaly_name=g("anomaly_name", 3),
        augmentations=g("augmentations", False),
        translate_zero=g("translate_zero", True),
        mean_t1=g("mean_t1", 610.7180906353575),
        std_t1=g("std_t1", 1018.7631901605115),
        mean_flair=g("mean_flair", 221.69656048399028),
        std_flair=g("std_flair", 386.31912016662903),
        mean_t2=g("mean_t2", 426.0168),
        std_t2=g("std_t2", 771.2276),
        mean_mnist=g("mean_mnist", 33.31842),
        std_mnist=g("std_mnist", 78.5679),
    )
    train = TrainConfig(project_name=str(g("ProjectName", "project")).strip("/"),
                        results_dir=g("Results", "./results"))
    return Config(model=model, diffusion=diffusion, sampler=sampler, ood=ood, data=data,
                  train=train)


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


def mri256_gated_config() -> Config:
    """`configs/mri_synthetic_256_gated.yaml`, the 256px chain with the
    classifier-gated phase B, built without YAML: fusion at t=5, so four
    post-fusion steps can reject; the gate is PatchCore over the denoiser's
    taps on its own bank of normal FLAIR images (`classifier_obj
    flair_denoiser`), suppress polarity, at most 3 retries, and a threshold
    ROC-calibrated at run time.  Stage A is the 256px default's.

    One value departs from the file: compute is bf16, the 256px default's.
    The file names no `compute_dtype`, so the JAX package runs it, and
    measured `results/gated_quality_r5.json`, in float32; its threshold
    and decisions belong to that precision.  At bf16 all eight kernels
    serve the chain; at float32 the GroupNorm and attention kernels do and
    the ResnetBlocks and linear attention take their plain modules, as in
    the JAX package.  `.replace(train=dataclasses.replace(cfg.train,
    compute_dtype="float32"))` gives the file's precision."""
    base = mri256_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, sampling_timesteps=None),
        sampler=dataclasses.replace(
            base.sampler, start_timestep=5, classifier=True,
            classifier_obj="flair_denoiser", max_classifier_retries=3,
            classifier_polarity="suppress",
        ),
        ood=dataclasses.replace(base.ood, classifier_threshold=None),
        train=TrainConfig(batch_size=8, lr=1e-4, results_dir="./results",
                          project_name="mri_synth256", compute_dtype="bfloat16"),
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


def mri256_bf16_config() -> Config:
    """`configs/mri_synthetic_256_bf16.yaml`, built without YAML: the 256px
    UNet of `mri256_config()`, DDIM-50 of T=250, bf16, and Stage A the
    file's: the 'seg' detector (a SegUNet, `ood.seg_model_path` or the
    shipped `results/seg256_params.npz`) with dilation 16 and no
    refinement.  `detector="patchcore"` turns it into the WRN50-2 path
    (`layers` layer2 ⊕ layer3 at a 256px input, the bank
    `ood.memory_bank_path` and its fitted ladder), as `scripts/test.py
    --detector patchcore` runs it."""
    base = mri256_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, sampling_timesteps=50),
        ood=OODConfig(
            detector="seg", input_size=256, mask_dilate=16,
            memory_bank_path="results/memory_bank_synthetic_brain_256.npy",
            layers=("layer2", "layer3"),
        ),
        train=dataclasses.replace(base.train, project_name="mri_synth256_bf16"),
    )


def mri64_config() -> Config:
    """`configs/mri_synthetic.yaml`, the 64px MRI flow, built without YAML:
    the 4-stage UNet at 64px, DDIM-50 of T=250, float32, the 'seg'
    detector; its PatchCore variant runs the WRN50-2's layer1 ⊕ layer2 at a
    64px input against the shipped `results/memory_bank_synthetic_brain.npy`
    (embedded with the JAX package's WRN weights, see ood/features.py)."""
    base = mri256_config()
    return Config(
        model=base.model,
        diffusion=dataclasses.replace(base.diffusion, image_size=64, sampling_timesteps=50),
        sampler=base.sampler,
        ood=OODConfig(
            detector="seg", input_size=64,
            memory_bank_path="results/memory_bank_synthetic_brain.npy",
            layers=("layer1", "layer2"),
        ),
        data=base.data,
        train=TrainConfig(batch_size=16, lr=1e-4, num_steps=400, results_dir="./results",
                          project_name="mri_synth"),
    )


def _mnist_model() -> ModelConfig:
    """The 28px MNIST UNet of every `configs/mnist*.yaml`."""
    return ModelConfig(dim=32, init_dim=32, dim_mults=(1, 2, 4),
                       full_attn=(False, False, True), channels=1,
                       cond_encoder_depth="shallow")


# the idx files the MNIST YAMLs name (both the t10k set), in DataConfig's
# default directory: the YAMLs' own absolute directory is outside the
# repository, and a command line's --mnist-path points at the files
MNIST_DIR = "./MNIST/raw"
MNIST_IMAGES = f"{MNIST_DIR}/t10k-images-idx3-ubyte"
MNIST_LABELS = f"{MNIST_DIR}/t10k-labels-idx1-ubyte"


def mnist_train_config() -> Config:
    """`configs/mnist_train.yaml`, the flagship's training configuration,
    built without YAML: the 28px UNet, T=250, the plain chain for the
    eval samples, batch 64, the streamed-epoch step."""
    return Config(
        model=_mnist_model(),
        diffusion=DiffusionConfig(image_size=28, timesteps=250, objective="pred_x0",
                                  beta_schedule="sigmoid"),
        sampler=SamplerConfig(branch_out=False, start_intermediate=False),
        data=DataConfig(name="mnist", mnist_path=MNIST_IMAGES, mnist_labels_path=MNIST_LABELS),
        train=TrainConfig(batch_size=64, lr=1e-4, num_steps=3000, step_mode="epoch",
                          results_dir="./results", project_name="mnist_x250"),
    )


def _mnist_test_config(mnist_cls: str, anomaly_name: int, **sampler) -> Config:
    """The MNIST test configurations' shared body (`configs/mnist_8to5.yaml`
    and its siblings): T=50 ancestral DDPM, branched with the manual
    7-column mask, the WRN50-2's bank path at an 84px input; `sampler`
    overrides the sampler's fields."""
    return Config(
        model=_mnist_model(),
        diffusion=DiffusionConfig(image_size=28, timesteps=50, sampling_timesteps=None,
                                  objective="pred_x0", beta_schedule="sigmoid"),
        sampler=SamplerConfig(**{**dict(branch_out=True, start_intermediate=True,
                                        start_timestep=2, mask_x=True, mask_x_policy="cond",
                                        cond_in_floor=0.5, ood_ad=True, classifier=False),
                                 **sampler}),
        ood=OODConfig(detector="manual", input_size=84,
                      memory_bank_path="results/memory_bank_mnist.npy", num_neighbors=9,
                      coreset_ratio=0.1, manual_mask_cols=7),
        data=DataConfig(name="mnist", mnist_path=MNIST_IMAGES, mnist_labels_path=MNIST_LABELS,
                        mnist_cls=mnist_cls, anomaly_name=anomaly_name),
        train=TrainConfig(results_dir="./results", project_name="mnist_x250"),
    )


def mnist_8to5_config() -> Config:
    """`configs/mnist_8to5.yaml`: digit 5 as the anomaly."""
    return _mnist_test_config("8to5", 5)


def mnist_gated_config() -> Config:
    """`configs/mnist_gated.yaml`: digit 3, the classifier-gated phase B
    with a fixed threshold of 3.5; with the manual detector the gate is
    `build_classifier_gate`'s WRN50-2 PatchCore on `ood.memory_bank_path`."""
    base = _mnist_test_config("8to3", 3, classifier=True)
    return base.replace(ood=dataclasses.replace(base.ood, classifier_threshold=3.5))


def mnist_usegt_config() -> Config:
    """`configs/mnist_usegt.yaml`: digit 3, the ground truth's noised
    in-distribution region substituted until t=20 (`use_gt`)."""
    return _mnist_test_config("8to3", 3, use_gt=True, use_gt_timestep=20)


def mvtec_synthetic_config(name: str = "synthetic_texture",
                           project_name: str = "mvtec_synth") -> Config:
    """`configs/mvtec_synthetic.yaml`, the 3-channel MVTec-style flow on
    synthetic textures, built without YAML: the 3-stage UNet at 64px, T=100
    ancestral DDPM, branched with the manual 12-column mask, the 'cond'
    mask_x policy at floor 0.95, float32, batch 16 at lr 2e-4."""
    return Config(
        model=ModelConfig(dim=32, init_dim=32, dim_mults=(1, 2, 4),
                          full_attn=(False, False, True), channels=3,
                          cond_encoder_depth="shallow"),
        diffusion=DiffusionConfig(image_size=64, timesteps=100, objective="pred_x0",
                                  beta_schedule="sigmoid"),
        sampler=SamplerConfig(branch_out=True, start_intermediate=True, start_timestep=2,
                              mask_x=True, mask_x_policy="cond", cond_in_floor=0.95,
                              ood_ad=True),
        ood=OODConfig(detector="manual", input_size=64, manual_mask_cols=12),
        data=DataConfig(name=name),
        train=TrainConfig(batch_size=16, lr=2e-4, num_steps=300, results_dir="./results",
                          project_name=project_name),
    )


def mvtec_denoise_config() -> Config:
    """`configs/mvtec_denoise.yaml`: `mvtec_synthetic_config()` with
    salt-and-pepper conditioning (`synthetic_texture_denoise`)."""
    return mvtec_synthetic_config("synthetic_texture_denoise", "mvtec_denoise")


# the builders by the names the command-line entry points take (`--config`)
CONFIGS = {
    "flagship": flagship_config,
    "mri256": mri256_config,
    "mri256_gated": mri256_gated_config,
    "mri256_bf16": mri256_bf16_config,
    "stem256": stem256_config,
    "mri64": mri64_config,
    "mnist_train": mnist_train_config,
    "mnist_8to5": mnist_8to5_config,
    "mnist_gated": mnist_gated_config,
    "mnist_usegt": mnist_usegt_config,
    "mvtec_synthetic": mvtec_synthetic_config,
    "mvtec_denoise": mvtec_denoise_config,
}


# what a command line's `--config` takes (`load_config`)
CONFIG_HELP = ("a builder name of config.CONFIGS, or a .json or .yaml configuration file (a "
               "Config.to_dict dump or the reference's flat keys)")


def load_config(spec: str) -> Config:
    """What a command line's `--config` names: a builder of `CONFIGS`, a
    `.json` file, or a `.yaml`/`.yml` file (PyYAML, imported here only);
    a file holding a `to_dict` dump (a 'model' section) goes through
    `from_dict`, the reference's flat key set through
    `reference_dict_to_config`."""
    if spec in CONFIGS:
        return CONFIGS[spec]()
    ext = os.path.splitext(spec)[1].lower()
    if ext not in (".json", ".yaml", ".yml"):
        raise ValueError(f"unknown configuration {spec!r}: a builder name ({sorted(CONFIGS)}), "
                         "a .json path or a .yaml path")
    read = json.load if ext == ".json" else _yaml().safe_load
    with open(spec) as f:
        raw = read(f)
    if isinstance(raw.get("model"), dict):
        return Config.from_dict(raw)
    return reference_dict_to_config(raw)


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
