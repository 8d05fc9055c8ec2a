"""Typed configuration (counterpart of ``codenerf_tpu/config``): the
schema, its loader and dumper, and ``yaml_lite``, the standard-library
reader and writer for the YAML the configs use."""

from codenerf_tpu_torch.config.schema import (  # noqa: F401
    DEPRECATED_KEYS, RENAMED_KEYS, SRN_CARS_CODE, Config, DatasetConfig,
    EmbedderConfig, EmbeddingSpec, ExperimentConfig, ModelsConfig,
    ModelSpec, NerfConfig, OptimizerConfig, PointSamplerConfig,
    RaySamplerConfig, RuntimeConfig, StageConfig, config_from_dict,
    dump_config, key_is_deprecated, key_is_renamed, load_config,
    register_deprecated_key, register_renamed_key)
