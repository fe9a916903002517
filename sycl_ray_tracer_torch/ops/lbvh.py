"""Morton codes on torch tensors (the JAX package's ops/lbvh.py
morton30; the port builds no LBVH)."""

from __future__ import annotations

import torch


def _expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zeros between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(p: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for points p [N, 3] in the box
    (lo, hi)."""
    extent = torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp((p - lo) / extent, 0.0, 1.0 - 1e-7)
    cell = (q * 1024.0).to(torch.int64)
    return ((_expand_bits(cell[:, 0]) << 2)
            | (_expand_bits(cell[:, 1]) << 1)
            | _expand_bits(cell[:, 2]))
