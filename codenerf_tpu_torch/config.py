"""The configuration fields the serving render, the train step and TTO
read.

A trimmed copy of ``codenerf_tpu/config/schema.py`` for the modern YAML
layout (``configs/srn-cars-code.yml``): the same nested names, so
``cfg.nerf.point_sampler.num_coarse`` means the same thing in both
packages.  ``load_config`` imports ``yaml`` inside the function only, so
the package imports on a machine without PyYAML; ``SRN_CARS_CODE`` carries
the flagship values as a literal for exactly that case.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Optional


@dataclass(frozen=True)
class ExperimentConfig:
    regularizer_lambda: float = 0.0


@dataclass(frozen=True)
class DatasetConfig:
    image_size: int = 128
    train_batch_size: int = 1


@dataclass(frozen=True)
class ModelSpec:
    type: str = "CodeNeRFModel"
    hidden_size: int = 128


@dataclass(frozen=True)
class EmbeddingSpec:
    shape_code_size: int = 128
    texture_code_size: int = 128


@dataclass(frozen=True)
class ModelsConfig:
    nerf_coarse: ModelSpec = field(default_factory=ModelSpec)
    nerf_fine: ModelSpec = field(default_factory=ModelSpec)
    embedding: EmbeddingSpec = field(default_factory=EmbeddingSpec)


@dataclass(frozen=True)
class OptimizerConfig:
    type: str = "AdamW"
    lr: float = 1e-4
    # None -> falls back to `lr`
    embedding_lr: Optional[float] = None
    # test-time optimization (eval/tto.py): None -> `type`
    val_type: Optional[str] = None
    val_lr: float = 5e-3
    # None -> `val_lr`
    angle_lr: Optional[float] = None
    radius_lr: Optional[float] = None
    scheduler_gamma: float = 0.1
    scheduler_step_size: int = 5000000
    # the SE(3)-tangent pose refinement after spherical TTO
    se3_refine_lr: float = 1e-3

    @property
    def resolved_embedding_lr(self) -> float:
        return self.lr if self.embedding_lr is None else self.embedding_lr

    @property
    def resolved_val_type(self) -> str:
        return self.type if self.val_type is None else self.val_type

    @property
    def resolved_angle_lr(self) -> float:
        return self.val_lr if self.angle_lr is None else self.angle_lr

    @property
    def resolved_radius_lr(self) -> float:
        return self.val_lr if self.radius_lr is None else self.radius_lr


@dataclass(frozen=True)
class RaySamplerConfig:
    num_random_rays: int = 4096


@dataclass(frozen=True)
class PointSamplerConfig:
    num_coarse: int = 32
    num_fine: int = 128
    near_limit: float = 0.8
    far_limit: float = 1.8
    # the reference's labels are inverted vs the NeRF convention:
    # "lindepth" is linear in disparity (see ops/sampling.py)
    spacing_mode: str = "lindepth"
    # stratified jitter and random inverse-CDF u (train and TTO renders)
    perturb: bool = True


@dataclass(frozen=True)
class EmbedderConfig:
    num_encoding_fn_xyz: int = 10
    include_input_xyz: bool = True
    log_sampling_xyz: bool = True
    use_viewdirs: bool = True
    num_encoding_fn_dir: int = 4
    include_input_dir: bool = True
    log_sampling_dir: bool = True


@dataclass(frozen=True)
class StageConfig:
    chunksize: int = 4096
    radiance_field_noise_std: float = 0.0


@dataclass(frozen=True)
class NerfConfig:
    ray_sampler: RaySamplerConfig = field(default_factory=RaySamplerConfig)
    point_sampler: PointSamplerConfig = field(
        default_factory=PointSamplerConfig)
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    white_background: bool = False
    train: StageConfig = field(default_factory=StageConfig)
    validation: StageConfig = field(default_factory=StageConfig)


@dataclass(frozen=True)
class RuntimeConfig:
    """The trunk's path, with the JAX schema's names and defaults
    (``codenerf_tpu/config/schema.py:211-260``; ``pipeline.py`` reads
    them):

    - ``use_pallas``: the fused trunk forward, K1; with
      ``pallas_backward`` its backward is K2, else autograd through the
      ray-structured forward, recomputed;
    - ``pallas_hybrid`` (without ``use_pallas``): a plain forward that
      stores the activations, K3 backward;
    - none of these: the ray-structured path
      (``models/ray_structured.py``), each relu layer's backward K4 under
      ``pallas_layer_bwd``, the forward recomputed in the backward under
      ``remat``; ``split_fc_out`` / ``fc_out_tail_sigma`` shape its
      fc_out.
    """
    compute_dtype: Optional[str] = "bfloat16"
    use_pallas: bool = False
    pallas_backward: bool = False
    pallas_hybrid: bool = False
    pallas_layer_bwd: bool = False
    remat: bool = False
    split_fc_out: bool = False
    fc_out_tail_sigma: bool = True
    # train step: accumulate the gradient over this many ray chunks
    ray_chunks: int = 1


@dataclass(frozen=True)
class Config:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    nerf: NerfConfig = field(default_factory=NerfConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


# The render-, train- and TTO-relevant values of configs/srn-cars-code.yml,
# in its layout.
SRN_CARS_CODE = {
    "experiment": {"regularizer_lambda": 1e-05},
    "dataset": {"image_size": 128, "train_batch_size": 4},
    "models": {
        "nerf_coarse": {"type": "CodeNeRFModel", "hidden_size": 256},
        "nerf_fine": {"type": "CodeNeRFModel", "hidden_size": 256},
        "embedding": {"shape_code_size": 256, "texture_code_size": 256},
    },
    "optimizer": {"type": "AdamW", "lr": 0.0001, "embedding_lr": 0.001,
                  "val_type": "AdamW", "val_lr": 0.005, "angle_lr": None,
                  "radius_lr": None, "scheduler_gamma": 0.1,
                  "scheduler_step_size": 5000000},
    "nerf": {
        "ray_sampler": {"num_random_rays": 4096},
        "point_sampler": {"num_coarse": 32, "num_fine": 128,
                          "near_limit": 0.8, "far_limit": 1.8,
                          "spacing_mode": "lindepth", "perturb": True},
        "embedder": {"num_encoding_fn_xyz": 10, "include_input_xyz": True,
                     "log_sampling_xyz": True, "use_viewdirs": True,
                     "num_encoding_fn_dir": 4, "include_input_dir": True,
                     "log_sampling_dir": True},
        "white_background": False,
        "train": {"chunksize": 4096, "radiance_field_noise_std": 0.0},
        "validation": {"chunksize": 4096, "radiance_field_noise_std": 0.0},
    },
    "runtime": {"compute_dtype": "bfloat16", "use_pallas": False,
                "remat": True, "pallas_hybrid": False, "ray_chunks": 1},
}


def _build(cls, d):
    """Instantiate dataclass ``cls`` from dict ``d``, recursing into
    nested dataclass fields and ignoring keys the port does not read."""
    d = d or {}
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        sub = f.default_factory
        if isinstance(sub, type) and is_dataclass(sub):
            kwargs[f.name] = _build(sub, d[f.name])
        else:
            kwargs[f.name] = d[f.name]
    return cls(**kwargs)


def config_from_dict(d: dict) -> Config:
    """Config from a nested dict in the YAML layout."""
    return _build(Config, d)


def load_config(path) -> Config:
    """Config from a YAML file in the modern layout.  Needs PyYAML, which
    is imported here only."""
    import yaml
    with open(Path(path)) as f:
        return config_from_dict(yaml.safe_load(f))
