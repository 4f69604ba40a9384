"""NeRF positional encoding (counterpart of ``zest_tpu.models.embedding``).

Layout ``[x, sin(f_0 x), cos(f_0 x), sin(f_1 x), ...]`` with f_k = 2^k, each
block C channels wide: out_channels = C * (2 * n_freqs + 1).
"""
from __future__ import annotations

import torch


def embedding_out_channels(in_channels: int, n_freqs: int) -> int:
    return in_channels * (2 * n_freqs + 1)


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Embed x [..., C] → [..., C * (2 * n_freqs + 1)]."""
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]                    # [..., F, C]
    sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], -2)  # [..., F, 2, C]
    return torch.cat([x, sc.flatten(-3)], -1)
