"""Vectorized material evaluation: diffuse / metallic / dielectric.

Parity target: material.hpp. The reference's tagged-union dispatch
(material.hpp:211-228) becomes branch-free masked evaluation: all three
scatter models are computed for every lane and the per-lane material
type selects the result.

Deviation (documented, SURVEY.md section 7): the diffuse near-zero guard
tests the *scattered* direction, fixing the reference's bug of testing
the incident direction (material.hpp:81-83).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.sampling import random_unit_vector
from sycl_ray_tracer_torch.ops.vec import (V3, dot, near_zero, reflect,
                                           refract, where)
from sycl_ray_tracer_torch.utils.gltf import (MAT_DIELECTRIC, MAT_DIFFUSE,
                                              MAT_METALLIC)

_I32_MIN = -2.0 ** 31
_I32_MAX = 2.0 ** 31 - 1


class MatLanes(NamedTuple):
    """Per-lane material properties, gathered from the scene tables."""
    mtype: torch.Tensor
    albedo: V3
    tex: torch.Tensor
    rough: torch.Tensor
    ior: torch.Tensor
    emissive: V3


def _texel_coord(c: torch.Tensor, res: int) -> torch.Tensor:
    # float -> int32 with saturation (the JAX package's conversion), then
    # a wrap that is always non-negative
    f = torch.floor(c * res).to(torch.float64).clamp(_I32_MIN, _I32_MAX)
    return f.to(torch.int64) % res


def sample_texture(scene, tex: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> V3:
    """Nearest-filter, repeat-wrap atlas lookup (render_wavefront.cpp
    sampler: normalized coords, repeat, nearest) with the reference's
    unorm_int8 read (bytes / 255, no sRGB decode). Lanes with tex < 0
    read texture 0 and are masked by the caller."""
    res = scene.tex_res
    x = _texel_coord(u, res)
    y = _texel_coord(v, res)
    t = torch.clamp(tex, min=0)
    w = scene.tex_packed[(t * res + y) * res + x]
    s = 1.0 / 255.0
    return V3((w & 0xFF).to(torch.float32) * s,
              ((w >> 8) & 0xFF).to(torch.float32) * s,
              ((w >> 16) & 0xFF).to(torch.float32) * s)


def albedo_lanes(scene, mat: MatLanes, u, v) -> V3:
    if not scene.has_textures:
        return mat.albedo
    tex = sample_texture(scene, mat.tex, u, v)
    return where(mat.tex >= 0, tex, mat.albedo)


def _schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """material.hpp:120-125."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def scatter(scene, mat: MatLanes, d_unit: V3, normal: V3,
            uv_u: torch.Tensor, uv_v: torch.Tensor,
            key: torch.Tensor, counter: int) -> tuple:
    """All-lanes scatter. Returns (continue_mask, new_dir, attenuation).

    d_unit must be unit length (trace_ray.hpp:61-62 normalizes before
    shading). new_dir is intentionally NOT normalized — the reference
    traces the raw scattered direction (trace_ray.hpp:72-74).
    """
    ruv = random_unit_vector(key, counter)
    u1 = _rng.uniform(key, counter + 0x55555555)

    albedo = albedo_lanes(scene, mat, uv_u, uv_v)

    # --- diffuse (material.hpp:72-86) --------------------------------
    dir_diff = normal + ruv
    dir_diff = where(near_zero(dir_diff), normal, dir_diff)

    # --- metallic (material.hpp:98-110) ------------------------------
    refl = reflect(d_unit, normal)
    dir_met = refl + ruv * mat.rough
    ok_met = dot(dir_met, normal) > 0.0

    # --- dielectric (material.hpp:127-156) ---------------------------
    front = dot(d_unit, normal) < 0.0
    n_face = where(front, normal, -normal)
    ratio = torch.where(front, 1.0 / mat.ior, mat.ior)
    cos_t = torch.clamp(dot(-d_unit, n_face), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ratio * sin_t > 1.0
    do_reflect = cannot | (_schlick(cos_t, ratio) > u1)
    dir_diel = where(do_reflect, reflect(d_unit, n_face),
                     refract(d_unit, n_face, ratio))

    # --- select by type ----------------------------------------------
    is_diff = mat.mtype == MAT_DIFFUSE
    is_met = mat.mtype == MAT_METALLIC
    is_diel = mat.mtype == MAT_DIELECTRIC

    new_dir = where(is_diff, dir_diff, where(is_met, dir_met, dir_diel))
    one = torch.ones_like(albedo.x)
    atten = where(is_diel, V3(one, one, one), albedo)
    cont = torch.where(is_met, ok_met, is_diff | is_diel)
    return cont, new_dir, atten
