"""The estimator's counter-based RNG (pcg2d, Jarzynski and Olano,
"Hash Functions for GPU Rendering", JCGT 2020), in plain torch.

Every draw is u32 = mix(key, counter), so any (pixel, sample) stream
can be drawn on its own: key = make_key(make_key(seed, sample), pixel),
counters 0 and 1 jitter the camera ray, bounce i draws at counter
i + 2 (and i + 2 + 0x55555555 for the dielectric's coin). 32-bit words
live in int64 tensors, masked after every add and multiply.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_MULT = 1664525
_PCG_MULT = 747796405


def _u32(x, device=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def _pcg2d(a, b):
    a = _u32(a)
    b = _u32(b, a.device)
    a = (a * _MULT + 0x9E3779B9) & _MASK
    b = (b * _MULT + 0x85EBCA6B) & _MASK
    a = (a + b * _MULT) & _MASK
    b = (b + a * _MULT) & _MASK
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    a = (a + b * _MULT) & _MASK
    b = (b + a * _MULT) & _MASK
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    return a, b


def make_key(seed, lane) -> torch.Tensor:
    if not isinstance(seed, torch.Tensor) and isinstance(lane, torch.Tensor):
        seed = _u32(seed, lane.device)
    a, b = _pcg2d(seed, lane)
    return a ^ ((b * _PCG_MULT) & _MASK)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniform(key: torch.Tensor, counter) -> torch.Tensor:
    return _unit(_pcg2d(key, counter)[0])


def uniform3(key: torch.Tensor, counter):
    key = _u32(key)
    a0, b0 = _pcg2d(key, counter)
    a1, _ = _pcg2d(key ^ 0x9E3779B9, counter)
    return _unit(a0), _unit(b0), _unit(a1)
