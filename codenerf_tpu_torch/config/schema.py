"""Typed configuration (counterpart of ``codenerf_tpu/config/schema.py``).

Every field of the JAX schema, with its name, default and nesting, so
``cfg.nerf.point_sampler.num_coarse`` means the same thing in both
packages and ``dataclasses.asdict`` of the two configs of one YAML file
are equal.  Kept from the JAX package (and through it the reference's
``CfgNode``):

  * the three YAML generations (modern, legacy ``models.coarse`` /
    ``models.fine``, and fern.yml's flat one) normalized by ``_normalize``;
  * dotted overrides ``a.b.c=value`` through ``ast.literal_eval`` with a
    string fallback, honouring the deprecated and renamed key registries;
  * ``.py`` configs exporting a ``cfg`` dict;
  * the resolved-config dump to the experiment logdir.

``load_config`` reads YAML with PyYAML when it can be imported and with
``yaml_lite`` (standard library only) otherwise; both resolve scalars as
``yaml.safe_load`` does, so the two give the same ``Config``.
``dump_config`` always writes with ``yaml_lite``.
"""

from __future__ import annotations

import ast
import dataclasses
import warnings
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional, Tuple

from codenerf_tpu_torch.config import yaml_lite


@dataclass(frozen=True)
class ExperimentConfig:
    id: str = "experiment"
    logdir: str = "logs"
    randomseed: int = 42
    iterations: int = 100000
    val_iterations: int = 300
    validate_every: int = 1000
    save_every: int = 5000
    print_every: int = 100
    val_print_every: int = 100
    regularizer_lambda: float = 0.0


@dataclass(frozen=True)
class DatasetConfig:
    type: str = "SRNDataset"
    basedir: str = ""
    image_size: int = 128
    world_scale: float = 1.0
    train_batch_size: int = 1
    val_batch_size: int = 1
    near: float = 0.8
    far: float = 1.8
    resolution_level: int = 1
    # llff-only knobs (fern.yml)
    downsample_factor: int = 8
    llffhold: int = 8
    no_ndc: bool = False


@dataclass(frozen=True)
class ModelSpec:
    type: str = "CodeNeRFModel"
    hidden_size: int = 128
    num_layers: int = 8
    skip_connect_ids: Tuple[int, ...] = (4,)


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
    # validation's multi-start pose TTO: probe this many azimuth inits
    # for `pose_restart_steps` steps each, continue from the lowest loss;
    # restart 0 is the reference init, the others sit at elevation
    # `pose_restart_theta` (harness.py::validate)
    pose_restarts: int = 1
    pose_restart_steps: int = 50
    pose_restart_theta: float = 1.2
    # after TTO, optimize the phi + pi candidate this many steps and keep
    # the basin with the lower loss on one shared ray draw; 0 = off
    pose_flip_steps: int = 0
    # 6-DOF SE(3)-tangent pose refinement after spherical TTO; 0 = off
    se3_refine_steps: int = 0
    se3_refine_lr: float = 1e-3
    # multi-view TTO: each of V views draws num_random_rays // V rays
    tto_view_ray_split: bool = False

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
    """Runtime switches, with the JAX schema's names and defaults.

    The trunk's path (``pipeline.py::trunk_path`` reads them):

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

    The train loop (``train/loop.py``) reads ``load_checkpoint`` (a
    checkpoint directory or one ``.ckpt`` file), ``profile_dir`` (a
    ``torch.profiler`` Chrome trace of five steady-state steps),
    ``checkify`` (NaN / inf checks in the train step) and ``ray_chunks``.
    ``int8_serving`` (with ``int8_encode``) adds the int8 serving render
    to every validation (``harness.py``, ``models/quantized.py``).
    ``num_devices`` is the data-parallel world's size, as it sizes JAX's
    mesh: ``harness.py`` joins the ranks that torchrun or ``train_cli -g``
    started (``parallel.mesh.init_world``); 0 takes them all, a larger
    number must equal their count, and without started ranks 0 or 1 is
    one device.
    """
    load_checkpoint: str = ""
    # ranks (one per device) to run on; 0 = every rank started
    num_devices: int = 0
    compute_dtype: Optional[str] = "bfloat16"
    use_pallas: bool = False
    pallas_backward: bool = False
    pallas_hybrid: bool = False
    pallas_layer_bwd: bool = False
    remat: bool = False
    # train step: accumulate the gradient over this many ray chunks
    ray_chunks: int = 1
    profile_dir: str = ""
    checkify: bool = False
    split_fc_out: bool = False
    fc_out_tail_sigma: bool = True
    int8_serving: bool = False
    int8_encode: bool = False


@dataclass(frozen=True)
class Config:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    nerf: NerfConfig = field(default_factory=NerfConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


# configs/srn-cars-code.yml as a literal, every key in its layout
# (tests/test_torch_isolation.py holds the two equal)
SRN_CARS_CODE = {
    "experiment": {"id": "cars-code-nerf-refactor-exp3", "logdir": "logs",
                   "randomseed": 55, "iterations": 500000,
                   "val_iterations": 300, "validate_every": 1000,
                   "save_every": 5000, "print_every": 100,
                   "val_print_every": 100, "regularizer_lambda": 1e-05},
    "dataset": {"type": "SRNDataset", "basedir": "data/srn_cars",
                "image_size": 128, "world_scale": 1.0,
                "train_batch_size": 4, "val_batch_size": 1, "near": 0.8,
                "far": 1.8, "resolution_level": 1, "downsample_factor": 8,
                "llffhold": 8, "no_ndc": False},
    "models": {
        "nerf_coarse": {"type": "CodeNeRFModel", "hidden_size": 256,
                        "num_layers": 8, "skip_connect_ids": (4,)},
        "nerf_fine": {"type": "CodeNeRFModel", "hidden_size": 256,
                      "num_layers": 8, "skip_connect_ids": (4,)},
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
    "runtime": {"load_checkpoint": "", "num_devices": 0,
                "compute_dtype": "bfloat16", "use_pallas": False,
                "remat": True, "profile_dir": "", "checkify": False},
}


# ---------------------------------------------------------------------------
# dict -> dataclass with legacy-schema normalization
# ---------------------------------------------------------------------------

def _filter_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _model_spec(d: dict) -> ModelSpec:
    d = dict(d)
    if "skip_connect_ids" in d:
        d["skip_connect_ids"] = tuple(d["skip_connect_ids"])
    # fern.yml's "skip_connect_every" has no working counterpart in the
    # reference model; the FlexibleNeRF default (4,) stands
    d.pop("skip_connect_every", None)
    return ModelSpec(**_filter_fields(ModelSpec, d))


def _normalize(raw: dict) -> dict:
    """The three historical schema generations in the modern layout."""
    raw = dict(raw or {})
    exp = dict(raw.get("experiment") or {})
    ds = dict(raw.get("dataset") or {})
    mdl = dict(raw.get("models") or {})
    opt = dict(raw.get("optimizer") or {})
    nerf = dict(raw.get("nerf") or {})

    # fern.yml generation: experiment.train_iters, a top-level scheduler
    # block, sampler keys under nerf.train / nerf.validation
    if "train_iters" in exp and "iterations" not in exp:
        exp["iterations"] = exp.pop("train_iters")
    sched = dict(raw.get("scheduler") or {})
    if sched:
        # lr_decay counts thousands of steps in the old schema
        opt.setdefault("scheduler_step_size",
                       int(sched.get("lr_decay", 250)) * 1000)
        opt.setdefault("scheduler_gamma", sched.get("lr_decay_factor", 0.1))

    train_stage = dict(nerf.get("train") or {})
    val_stage = dict(nerf.get("validation") or {})

    ray_sampler = dict(nerf.get("ray_sampler") or {})
    if ("num_random_rays" not in ray_sampler
            and "num_random_rays" in train_stage):
        ray_sampler["num_random_rays"] = train_stage["num_random_rays"]

    point_sampler = dict(nerf.get("point_sampler") or {})
    if not point_sampler and "num_coarse" in train_stage:
        # old flat schema: lindisp False = linear in depth, which the
        # modern (inverted) labels call "lindisp"
        point_sampler = {
            "num_coarse": train_stage.get("num_coarse", 64),
            "num_fine": train_stage.get("num_fine", 128),
            "near_limit": ds.get("near", 0.0),
            "far_limit": ds.get("far", 1.0),
            "perturb": train_stage.get("perturb", True),
            "spacing_mode": ("lindepth" if train_stage.get("lindisp", False)
                             else "lindisp"),
        }

    # legacy models.coarse / models.fine -> nerf_coarse / nerf_fine
    coarse = mdl.get("nerf_coarse") or mdl.get("coarse") or {}
    fine = mdl.get("nerf_fine") or mdl.get("fine") or {}

    embedder = dict(nerf.get("embedder") or {})
    if not embedder and ("num_encoding_fn_xyz" in coarse):
        embedder = {k: coarse[k] for k in (
            "num_encoding_fn_xyz", "include_input_xyz", "log_sampling_xyz",
            "use_viewdirs", "num_encoding_fn_dir", "include_input_dir",
            "log_sampling_dir") if k in coarse}

    return {
        "experiment": exp,
        "dataset": ds,
        "models": {
            "nerf_coarse": coarse,
            "nerf_fine": fine,
            "embedding": mdl.get("embedding") or {},
        },
        "optimizer": opt,
        "nerf": {
            "ray_sampler": ray_sampler,
            "point_sampler": point_sampler,
            "embedder": embedder,
            "white_background": nerf.get("white_background", False),
            "train": _filter_fields(StageConfig, train_stage),
            "validation": _filter_fields(StageConfig, val_stage),
        },
        "runtime": dict(raw.get("runtime") or {}),
    }


def config_from_dict(raw: dict) -> Config:
    """Config from a nested dict of any schema generation; unknown keys
    are ignored."""
    n = _normalize(raw)
    return Config(
        experiment=ExperimentConfig(**_filter_fields(ExperimentConfig,
                                                     n["experiment"])),
        dataset=DatasetConfig(**_filter_fields(DatasetConfig, n["dataset"])),
        models=ModelsConfig(
            nerf_coarse=_model_spec(n["models"]["nerf_coarse"]),
            nerf_fine=_model_spec(n["models"]["nerf_fine"]),
            embedding=EmbeddingSpec(**_filter_fields(
                EmbeddingSpec, n["models"]["embedding"])),
        ),
        optimizer=OptimizerConfig(**_filter_fields(OptimizerConfig,
                                                   n["optimizer"])),
        nerf=NerfConfig(
            ray_sampler=RaySamplerConfig(**_filter_fields(
                RaySamplerConfig, n["nerf"]["ray_sampler"])),
            point_sampler=PointSamplerConfig(**_filter_fields(
                PointSamplerConfig, n["nerf"]["point_sampler"])),
            embedder=EmbedderConfig(**_filter_fields(
                EmbedderConfig, n["nerf"]["embedder"])),
            white_background=bool(n["nerf"]["white_background"]),
            train=StageConfig(**n["nerf"]["train"]),
            validation=StageConfig(**n["nerf"]["validation"]),
        ),
        runtime=RuntimeConfig(**_filter_fields(RuntimeConfig,
                                               n["runtime"])),
    )


# -- deprecated / renamed key registries (reference cfg_node.py:270-319) ----
# Overrides of a deprecated key warn and are ignored; overrides of a
# renamed key raise with the new spelling.  YAML files of the older
# generations are migrated by _normalize; these guard dotted overrides.
DEPRECATED_KEYS: set = {
    "models.nerf_coarse.skip_connect_every",
    "models.nerf_fine.skip_connect_every",
}
# a value is the new dotted key, or (new_key, message) where the rename
# is not a pure respelling
RENAMED_KEYS: dict = {
    "experiment.train_iters": "experiment.iterations",
    "models.coarse": "models.nerf_coarse",
    "models.fine": "models.nerf_fine",
    "nerf.train.num_random_rays": "nerf.ray_sampler.num_random_rays",
    "scheduler.lr_decay": ("optimizer.scheduler_step_size",
                           "note the unit change: the old key counted "
                           "thousands of steps, the new key counts steps "
                           "(multiply your value by 1000)"),
    "scheduler.lr_decay_factor": "optimizer.scheduler_gamma",
}


def register_deprecated_key(key: str) -> None:
    """Overrides of ``key`` warn and are ignored (cfg_node.py:270-279)."""
    if key in DEPRECATED_KEYS:
        raise ValueError(f"key {key} is already registered as deprecated")
    DEPRECATED_KEYS.add(key)


def register_renamed_key(old: str, new: str) -> None:
    """Overrides of ``old`` raise, pointing at ``new``
    (cfg_node.py:282-296)."""
    if old in RENAMED_KEYS:
        raise ValueError(f"key {old} is already registered as renamed")
    RENAMED_KEYS[old] = new


def key_is_deprecated(full_key: str) -> bool:
    return full_key in DEPRECATED_KEYS


def key_is_renamed(full_key: str) -> bool:
    return full_key in RENAMED_KEYS


def _apply_override(cfg: Config, dotted: str, value) -> Config:
    """Apply one ``a.b.c=value`` override immutably, honouring the
    deprecated / renamed registries (cfg_node.py:208-236)."""
    if key_is_deprecated(dotted):
        warnings.warn(f"deprecated config key (ignoring): {dotted}")
        return cfg
    if key_is_renamed(dotted):
        target = RENAMED_KEYS[dotted]
        note = ""
        if isinstance(target, tuple):
            target, note = target[0], f" ({target[1]})"
        raise KeyError(f"key {dotted} was renamed to {target}; "
                       f"please update your override{note}")

    def rec(node, keys):
        if not dataclasses.is_dataclass(node):
            raise KeyError(f"cannot descend into non-config node at {keys}")
        name = keys[0]
        if name not in {f.name for f in dataclasses.fields(node)}:
            raise KeyError(f"unknown config key: {dotted}")
        if len(keys) == 1:
            new = value
            if isinstance(getattr(node, name), tuple) and isinstance(new,
                                                                     list):
                new = tuple(new)
            return dataclasses.replace(node, **{name: new})
        return dataclasses.replace(
            node, **{name: rec(getattr(node, name), keys[1:])})

    return rec(cfg, dotted.split("."))


def _load_py_config(path: Path) -> dict:
    """A Python config: a module exporting a ``cfg`` dict
    (cfg_node.py:370-384)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("codenerf_config_source",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, "cfg"):
        raise ValueError(f"python config {path} must export a 'cfg' dict")
    if not isinstance(module.cfg, dict):
        raise ValueError(f"'cfg' in {path} must be a dict, "
                         f"got {type(module.cfg)}")
    return module.cfg


def _read_yaml(path: Path):
    """``yaml.safe_load`` of ``path``, through ``yaml_lite`` where PyYAML
    cannot be imported."""
    text = path.read_text()
    try:
        import yaml
    except ImportError:
        return yaml_lite.safe_load(text)
    return yaml.safe_load(text)


def load_config(path: str | Path, overrides: Optional[list] = None
                ) -> Config:
    """A YAML or Python config (any schema generation) with dotted
    overrides such as ``optimizer.lr=3e-4``, their values through
    ``ast.literal_eval`` with a string fallback (cfg_node.py:386-414)."""
    path = Path(path)
    raw = _load_py_config(path) if path.suffix == ".py" else _read_yaml(path)
    cfg = config_from_dict(raw)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        try:
            value = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            value = val
        cfg = _apply_override(cfg, key.strip(), value)
    return cfg


def dump_config(cfg: Config, path: str | Path) -> None:
    """Write the resolved config as YAML (reference util.py:53-55); PyYAML
    and ``yaml_lite`` read it back to ``asdict(cfg)``, tuples as lists."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml_lite.dump(asdict(cfg)))
