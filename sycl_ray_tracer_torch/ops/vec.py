"""Structure-of-arrays 3-vector math on torch tensors.

Vectors are three same-shaped tensors (``V3``), the layout of the JAX
package's ops/vec.py, so each function here has a counterpart of the
same name there.

Behavioral parity targets (reference):
- reflect/refract/near_zero: src/util.hpp:103-125
- linear_to_gamma = sqrt:    src/util.hpp:82-101
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    """Three same-shaped tensors acting as one vector field."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length_squared(a: V3) -> torch.Tensor:
    return dot(a, a)


def normalize(a: V3, eps: float = 0.0) -> V3:
    # eps guards the zero vector only where callers ask for it.
    return a * torch.rsqrt(dot(a, a) + eps)


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def reflect(v: V3, n: V3) -> V3:
    """v - 2*dot(v,n)*n  (ref: util.hpp:114-116)."""
    return v - n * (2.0 * dot(v, n))


def refract(uv: V3, n: V3, etai_over_etat: torch.Tensor) -> V3:
    """Snell refraction (ref: util.hpp:118-125)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = (uv + n * cos_theta) * etai_over_etat
    r_out_parallel = -torch.sqrt(torch.abs(1.0 - length_squared(r_out_perp)))
    return r_out_perp + n * r_out_parallel


def near_zero(v: V3, s: float = 1e-8) -> torch.Tensor:
    """True where |v| < s componentwise (ref: util.hpp:103-107)."""
    return (v.x.abs() < s) & (v.y.abs() < s) & (v.z.abs() < s)


def linear_to_gamma(c: torch.Tensor) -> torch.Tensor:
    """sqrt gamma, clamped at 0 (ref: util.hpp:82-92)."""
    return torch.sqrt(torch.clamp(c, min=0.0))
