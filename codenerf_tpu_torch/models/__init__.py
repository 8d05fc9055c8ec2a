"""CodeNeRF MLP, latent code tables and the ray-structured apply
(counterpart of ``codenerf_tpu/models``)."""

from codenerf_tpu_torch.models.mlp import CodeNeRFConfig, CodeNeRF  # noqa: F401
from codenerf_tpu_torch.models.codes import (  # noqa: F401
    CodeTables, code_table_norms, lookup_codes, mean_codes)
