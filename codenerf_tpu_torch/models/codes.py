"""Per-object shape/texture latent code tables (counterpart of
``codenerf_tpu/models/codes.py``; reference model.py:87-120)."""

from __future__ import annotations

import torch
from torch import nn

from codenerf_tpu_torch.device import resolve_device


class CodeTables(nn.Module):
    """The reference's ``ShapeTextureEmbedding``: two embedding tables,
    N(0, 1) at init (model.py:99-100), with its state-dict names.  Drawn
    on the CPU from ``generator`` (a CPU ``torch.Generator``) and moved to
    ``device``."""

    def __init__(self, num_objects: int, shape_code_size: int,
                 texture_code_size: int, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.shape_embedding = nn.Embedding(num_objects, shape_code_size)
        self.texture_embedding = nn.Embedding(num_objects, texture_code_size)
        with torch.no_grad():
            self.shape_embedding.weight.normal_(generator=generator)
            self.texture_embedding.weight.normal_(generator=generator)
        self.to(dev)


def lookup_codes(tables: CodeTables, object_ids: torch.Tensor):
    """(z_s, z_t) for a batch of object ids (model.py:102-105)."""
    return (tables.shape_embedding.weight[object_ids],
            tables.texture_embedding.weight[object_ids])


def mean_codes(tables: CodeTables):
    """Mean of each table, [1, C] — the TTO initialization
    (reference eval.py:126-127)."""
    return (tables.shape_embedding.weight.mean(dim=0, keepdim=True),
            tables.texture_embedding.weight.mean(dim=0, keepdim=True))


def code_table_norms(tables: CodeTables):
    """L2 norm of each flattened table, for the training regularizer
    (model.py:113-120 + train.py:107)."""
    return (torch.linalg.norm(tables.shape_embedding.weight.reshape(-1)),
            torch.linalg.norm(tables.texture_embedding.weight.reshape(-1)))
