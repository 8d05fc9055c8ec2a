"""Fourier positional encoding (counterpart of
``codenerf_tpu/core/encoding.py``).

Feature order as in the reference (position_embed.py:44-53): optional
identity first, then for each band f_k the full-dimension sin(x f_k)
followed by cos(x f_k).
"""

from __future__ import annotations

import torch


def frequency_bands(num_freq: int, log_sampling: bool,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """2^linspace(0, F-1, F) (log) or linspace(1, 2^(F-1), F) (linear)."""
    if log_sampling:
        return 2.0 ** torch.linspace(0.0, num_freq - 1, num_freq,
                                     dtype=dtype, device=device)
    return torch.linspace(1.0, 2.0 ** (num_freq - 1), num_freq,
                          dtype=dtype, device=device)


def encoding_dim(in_dim: int, num_freq: int, include_input: bool) -> int:
    return in_dim * ((1 if include_input else 0) + 2 * num_freq)


def positional_encoding(x: torch.Tensor, num_freq: int,
                        include_input: bool = True,
                        log_sampling: bool = True) -> torch.Tensor:
    """Encode [..., D] -> [..., D*(include + 2F)]:
    [x?, sin(x f0), cos(x f0), sin(x f1), ...]."""
    bands = frequency_bands(num_freq, log_sampling, x.dtype, x.device)
    scaled = x[..., None, :] * bands[:, None]                  # [..., F, D]
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freq * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
