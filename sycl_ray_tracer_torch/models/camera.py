"""Pinhole camera + jittered primary-ray generation.

Parity target: camera.hpp:74-131. Basis from world_up (0,1,0), viewport
height fixed at 1.0, width = aspect; focal length comes from glTF yfov
as 1/tan(yfov/2) (scene.cpp:127). Primary ray directions are
*unnormalized* (pixel_sample - center), exactly like the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.vec import V3


class Camera(NamedTuple):
    center: torch.Tensor      # [3]
    pixel00: torch.Tensor     # [3] viewport top-left corner point
    delta_u: torch.Tensor     # [3] per-pixel step along +x
    delta_v: torch.Tensor     # [3] per-pixel step along +y (downward)
    width: int
    height: int


def make_camera(width: int, height: int, position, direction,
                focal_length: float, device="cpu") -> Camera:
    """camera.hpp:74-106, computed in float64 numpy, stored f32."""
    pos = np.asarray(position, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-20)
    world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(d, world_up)
    right = right / max(np.linalg.norm(right), 1e-20)
    up = np.cross(right, d)
    up = up / max(np.linalg.norm(up), 1e-20)

    vw = float(width) / float(height)
    vh = 1.0
    pixel00 = pos - right * vw + up * vh + d * focal_length
    delta_u = right * (2.0 * vw / width)
    delta_v = -up * (2.0 * vh / height)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return Camera(center=f32(pos), pixel00=f32(pixel00),
                  delta_u=f32(delta_u), delta_v=f32(delta_v),
                  width=int(width), height=int(height))


def generate_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                  key: torch.Tensor):
    """Jittered rays for integer pixel coords (camera.hpp:109-131).
    Jitter uses RNG counters 0 and 1. Returns (o, d) as V3 of [R]."""
    jx = _rng.uniform(key, 0) - 0.5
    jy = _rng.uniform(key, 1) - 0.5
    fx = px.to(torch.float32) + jx
    fy = py.to(torch.float32) + jy

    def axis(i):
        return (cam.pixel00[i] + fx * cam.delta_u[i] + fy * cam.delta_v[i]
                - cam.center[i])

    d = V3(axis(0), axis(1), axis(2))
    r = px.shape[0]
    o = V3(*(cam.center[i].expand(r).contiguous() for i in range(3)))
    return o, d
