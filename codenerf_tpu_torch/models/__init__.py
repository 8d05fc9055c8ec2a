"""CodeNeRF and vanilla NeRF MLPs, latent code tables and the
ray-structured applies (counterpart of ``codenerf_tpu/models``)."""

from codenerf_tpu_torch.models.mlp import (  # noqa: F401
    CodeNeRF, CodeNeRFConfig, FlexibleNeRF, FlexibleNeRFConfig, build_model)
from codenerf_tpu_torch.models.codes import (  # noqa: F401
    CodeTables, code_table_norms, lookup_codes, mean_codes)
