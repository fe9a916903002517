"""Counter-based parallel RNG (the pcg2d hash), bit-exact with the JAX
package's ops/rng.py.

Every draw is a pure function ``u32 = mix(key, counter)``: lanes share
no state, so the same bits come out of the numpy oracle, the JAX
renderers and this port. The mixer is Jarzynski & Olano's pcg2d
("Hash Functions for GPU Rendering", JCGT 2020).

torch has no full uint32 arithmetic, so 32-bit words live in int64
tensors holding values in [0, 2^32). Every add or multiply is masked
back to 32 bits before the next shift, which keeps shifts logical.
No intermediate product exceeds 2^62 (a 32-bit word times a multiplier
below 2^30), so int64 never overflows.

The *_np functions are the numpy twins (uint32 arithmetic that wraps),
the draws of the numpy oracle (models/oracle.py); they equal the JAX
package's make_key_np, uniform_np and uniform3_np bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracer_torch.utils import profile as _profile

_MASK = 0xFFFFFFFF
_MULT = 1664525
# Multiplier from the PCG family (Melissa O'Neill's PCG, public domain).
_PCG_MULT = 747796405


def _u32(x, device=None) -> torch.Tensor:
    """Any int tensor or Python int -> int64 tensor of 32-bit words. A
    Python int becomes a tensor on `device`: on the card a copy from
    pageable memory that waits for the stream (the "scalar" wait of
    utils/profile.py:sync)."""
    if not isinstance(x, torch.Tensor):
        with _profile.sync("scalar"):
            return torch.tensor(int(x) & _MASK, dtype=torch.int64,
                                device=device)
    return x.to(torch.int64) & _MASK


def _pcg2d(a: torch.Tensor, b: torch.Tensor):
    a = _u32(a)
    b = _u32(b, a.device)
    # Golden-ratio increments kill the all-zero fixed point.
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
    """Per-lane key from (seed, lane): `seed` folds in the sample index
    so every (pixel, sample) pair gets an independent stream. Either
    argument may be a Python int; the result is an int64 tensor of
    32-bit words with the broadcast shape of the two."""
    if not isinstance(seed, torch.Tensor) and isinstance(lane,
                                                         torch.Tensor):
        seed = _u32(seed, lane.device)
    a, b = _pcg2d(seed, lane)
    return a ^ ((b * _PCG_MULT) & _MASK)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    # Top 24 bits -> [0, 1), exactly representable in f32.
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniform(key: torch.Tensor, counter) -> torch.Tensor:
    """One uniform f32 in [0, 1) per lane; `counter` numbers the draw."""
    a, _ = _pcg2d(key, counter)
    return _bits_to_unit_float(a)


def uniform3(key: torch.Tensor, counter):
    """Three uniforms per lane from one counter: both pcg2d outputs at
    (key, counter) plus the first output at (key ^ golden, counter).
    The first value equals uniform(key, counter)."""
    key = _u32(key)
    a0, b0 = _pcg2d(key, counter)
    a1, _ = _pcg2d(key ^ 0x9E3779B9, counter)
    return (_bits_to_unit_float(a0), _bits_to_unit_float(b0),
            _bits_to_unit_float(a1))


# ---------------------------------------------------------------------
# numpy twins (uint32 arrays) for the oracle
# ---------------------------------------------------------------------

_U32 = np.uint32


def _pcg2d_np(a: np.ndarray, b: np.ndarray):
    with np.errstate(over="ignore"):
        a = a.astype(_U32)
        b = b.astype(_U32)
        mult = _U32(_MULT)
        a = a * mult + _U32(0x9E3779B9)
        b = b * mult + _U32(0x85EBCA6B)
        a = (a + b * mult).astype(_U32)
        b = (b + a * mult).astype(_U32)
        a = a ^ (a >> _U32(16))
        b = b ^ (b >> _U32(16))
        a = (a + b * mult).astype(_U32)
        b = (b + a * mult).astype(_U32)
        a = a ^ (a >> _U32(16))
        b = b ^ (b >> _U32(16))
    return a, b


def make_key_np(seed, lane) -> np.ndarray:
    a, b = _pcg2d_np(np.asarray(seed, _U32), np.asarray(lane, _U32))
    with np.errstate(over="ignore"):
        return a ^ (b * _U32(_PCG_MULT))


def _bits_to_unit_float_np(bits: np.ndarray) -> np.ndarray:
    return (bits >> _U32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def uniform_np(key, counter) -> np.ndarray:
    a, _ = _pcg2d_np(np.asarray(key, _U32), np.asarray(counter, _U32))
    return _bits_to_unit_float_np(a)


def uniform3_np(key, counter):
    key = np.asarray(key, _U32)
    c = np.asarray(counter, _U32)
    a0, b0 = _pcg2d_np(key, c)
    a1, _ = _pcg2d_np(key ^ _U32(0x9E3779B9), c)
    return (_bits_to_unit_float_np(a0), _bits_to_unit_float_np(b0),
            _bits_to_unit_float_np(a1))
