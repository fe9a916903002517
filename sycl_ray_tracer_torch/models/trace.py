"""Per-vertex pieces of the path: intersection, shading inputs and
Russian roulette.

Parity target: trace_ray.hpp:11-82 and its termination algebra, which
models/wavefront.py applies:

- miss       -> contribute attenuation * (sky_color + radiance)
- hit        -> radiance += emitted(); scatter
- absorbed   -> contribute attenuation * radiance
- scattered  -> origin += t * dir (unnormalized dir), dir = scatter dir,
                attenuation *= scatter attenuation, path continues
"""

from __future__ import annotations

import torch

from sycl_ray_tracer_torch.models import materials as mats
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.intersect import Hit
from sycl_ray_tracer_torch.ops.traverse8 import traverse8
from sycl_ray_tracer_torch.ops.vec import V3, normalize

# Russian roulette starts at this bounce (rr=True paths only) and
# clamps survival probability to at least this floor.
RR_START = 3
RR_FLOOR = 0.05


def intersect_scene(scene, o: V3, d: V3) -> Hit:
    """Closest hit through the SAH BVH8 (ops/traverse8.py), with hit ids
    mapped from SAH slots to the canonical Morton slots that every
    shading table uses."""
    hit = traverse8(scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
                    scene.sah_ni, o, d)
    tri = torch.where(hit.tri >= 0,
                      scene.bvh_remap[hit.tri.clamp(min=0).to(torch.int64)],
                      -1)
    return hit._replace(tri=tri)


def rr_survive(att: V3, key: torch.Tensor, counter: int):
    """Russian-roulette survival: (survive_mask, scaled_att).

    Survival probability = max throughput component (clamped); the
    survivor's throughput is scaled by 1/p, keeping the estimator
    unbiased. Extension over the reference (which never terminates
    early); required by BASELINE config 3.
    """
    p = torch.clamp(torch.maximum(att.x, torch.maximum(att.y, att.z)),
                    RR_FLOOR, 1.0)
    u = _rng.uniform(key, counter + 0x33333333)
    survive = u < p
    inv_p = 1.0 / p
    return survive, V3(att.x * inv_p, att.y * inv_p, att.z * inv_p)


def shade_lanes(scene, hit: Hit):
    """Interpolated shading inputs for hit lanes (garbage on miss
    lanes; callers mask): barycentric normal/UV interpolation + the
    normalize of trace_ray.hpp:32-59, from one row gather of the
    triangle-major shading table plus [M]-table gathers keyed by the
    material id."""
    c = scene.shade_tbl[hit.tri.clamp(min=0)].unbind(1)
    w = 1.0 - hit.u - hit.v
    nx = w * c[0] + hit.u * c[3] + hit.v * c[6]
    ny = w * c[1] + hit.u * c[4] + hit.v * c[7]
    nz = w * c[2] + hit.u * c[5] + hit.v * c[8]
    normal = normalize(V3(nx, ny, nz), eps=1e-20)
    uv_u = w * c[9] + hit.u * c[11] + hit.v * c[13]
    uv_v = w * c[10] + hit.u * c[12] + hit.v * c[14]
    mid = c[15].to(torch.int64)
    alb = scene.mat_albedo[mid]
    emi = scene.mat_emissive[mid]
    mat = mats.MatLanes(
        mtype=scene.mat_type[mid],
        albedo=V3(alb[:, 0], alb[:, 1], alb[:, 2]),
        tex=scene.mat_tex[mid],
        rough=scene.mat_rough[mid],
        ior=scene.mat_ior[mid],
        emissive=V3(emi[:, 0], emi[:, 1], emi[:, 2]),
    )
    return normal, uv_u, uv_v, mat
