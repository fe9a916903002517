"""Per-vertex pieces of the path: intersection, shading inputs, Russian
roulette, and the masked path-vertex step of the megakernel.

Parity target: trace_ray.hpp:11-82 and its termination algebra, which
models/wavefront.py applies to its compacted queue and trace_step to
every lane of a megakernel wave:

- miss       -> contribute attenuation * (sky_color + radiance)
- hit        -> radiance += emitted(); scatter
- absorbed   -> contribute attenuation * radiance
- scattered  -> origin += t * dir (unnormalized dir), dir = scatter dir,
                attenuation *= scatter attenuation, path continues

On the card the shade and scatter stages are one hand-written kernel
each (ops/vertex.py, csrc/vertex.cu), which compute these functions per
lane; on the CPU they are the plain torch code below, their reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sycl_ray_tracer_torch.models import materials as mats
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops import vertex as _vertex
from sycl_ray_tracer_torch.ops.intersect import Hit
from sycl_ray_tracer_torch.ops.traverse import traverse
from sycl_ray_tracer_torch.ops.traverse1 import traverse1
from sycl_ray_tracer_torch.ops.traverse5 import traverse5
from sycl_ray_tracer_torch.ops.traverse8 import traverse8
from sycl_ray_tracer_torch.ops.vec import V3, normalize, where
from sycl_ray_tracer_torch.utils import profile as _profile

# Russian roulette starts at this bounce (rr=True paths only) and
# clamps survival probability to at least this floor.
RR_START = 3
RR_FLOOR = 0.05


class PathState(NamedTuple):
    o: V3                # ray origin
    d: V3                # ray direction (unnormalized, reference convention)
    att: V3              # accumulated attenuation
    rad: V3              # accumulated radiance
    result: V3           # final color once done
    done: torch.Tensor   # bool


def start_state(o: V3, d: V3) -> PathState:
    """A wave's first state: attenuation 1, radiance and result 0, no
    lane done. Each column is a tensor of its own, since the card's
    scatter stage updates the state in place."""
    ar = torch.zeros((9, o.x.shape[0]), dtype=torch.float32,
                     device=o.x.device)
    ar[0:3] = 1.0
    return PathState(o=o, d=d, att=V3(*ar[0:3]), rad=V3(*ar[3:6]),
                     result=V3(*ar[6:9]),
                     done=torch.zeros_like(o.x, dtype=torch.bool))


def intersect_scene(scene, o: V3, d: V3,
                    active: torch.Tensor | None = None,
                    ordered: bool = False) -> Hit:
    """Closest hit of the active rays (all when active is None), with
    hit ids in the slots that every shading table uses. Heap scenes
    (leaf_size != 8) go through the Morton heap with K-slot MT leaves
    (ops/traverse1.py), whose ids are already Morton slots. Baked K=8
    scenes go through the SAH BVH8 with Woop leaves (ops/traverse8.py)
    and two-level instanced scenes through the global tree with
    instance-transformed MT leaves (ops/traverse5.py, itf mode); their
    ids map through bvh_remap (SAH slot -> canonical Morton slot;
    global slot -> inst * S8 + shared row). Scenes built with
    intersector="lbvh" go through the binary-LBVH walk in plain torch
    (ops/traverse.py), whose ids are Morton slots too. `ordered` (with
    `active`) asks traverse8 to gather the live lanes' rays in buckets of
    their dir6_morton key over the scene's box and walk them in that
    order; the other walks take them in lane order. The hits are the
    same either way."""
    if scene.intersector == "lbvh":
        return traverse(scene.lbvh_lo, scene.lbvh_hi, scene.lbvh_v0,
                        scene.lbvh_e1, scene.lbvh_e2, o, d, scene.leaf_size,
                        active_in=active)
    if scene.has_heap:
        return traverse1(scene.bvh_children, scene.bvh_leaves, scene.bvh_ni,
                         scene.leaf_size, o, d, active=active)
    if scene.has_instances:
        hit = traverse5(scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_mt,
                        scene.sah_ni, o, d, active=active,
                        leaf_slot=scene.inst_leaf_slot, leaf_xf=scene.inst_xf)
    else:
        box = ((scene.scene_lo, scene.scene_hi)
               if ordered and active is not None else None)
        hit = traverse8(scene.bvh_nodes, scene.bvh_child_ids,
                        scene.bvh_woop, scene.sah_ni, o, d, active=active,
                        order_box=box)
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
    material id.

    On an instanced scene a hit id is inst * S8 + shared row
    (models/instanced.py): the row indexes the shared table, whose
    normals are in local space, and the instance's inverse transpose
    rotates the interpolated normal to world space before the
    normalize (the baked ingest applies the same matrix per vertex)."""
    tri = hit.tri.clamp(min=0).to(torch.int64)
    if scene.has_instances:
        inst, tri = tri // scene.inst_s8, tri % scene.inst_s8
    c = scene.shade_tbl[tri].unbind(1)
    w = 1.0 - hit.u - hit.v
    nx = w * c[0] + hit.u * c[3] + hit.v * c[6]
    ny = w * c[1] + hit.u * c[4] + hit.v * c[7]
    nz = w * c[2] + hit.u * c[5] + hit.v * c[8]
    if scene.has_instances:
        nm = scene.inst_nmat[inst].unbind(1)
        nx, ny, nz = (nm[0] * nx + nm[1] * ny + nm[2] * nz,
                      nm[3] * nx + nm[4] * ny + nm[5] * nz,
                      nm[6] * nx + nm[7] * ny + nm[8] * nz)
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


def trace_step(scene, state: PathState, key: torch.Tensor,
               bounce_counter: int, rr: bool = False) -> PathState:
    """Advance every lane that is not done by one path vertex; done
    lanes keep their state. Bounce i uses RNG counter i + 2 (0 and 1
    are the camera jitter). The expressions are those of the JAX
    package's trace_step (trace.py:466-519), in the same order, and per
    lane those of models/wavefront.py:_bounce, so that both engines
    compute the same paths. The stages run in utils/profile.py:stage.
    The intersection walks bounce rays (bounce_counter > 2) in coherence
    order (intersect_scene's `ordered`): after the first bounce
    neighbouring lanes shoot into every direction; camera rays keep lane
    order, in which neighbouring pixels are coherent already (ordering
    them measured slower, chip_smoke.py phase 4f).
    On the card shade and scatter are one kernel each (step_by_hand),
    which update the state in place; on the CPU they are plain torch
    (step_plain)."""
    with _profile.stage("intersect"):
        hit = intersect_scene(scene, state.o, state.d, active=~state.done,
                              ordered=bounce_counter > 2)
        miss = hit.tri < 0
    step = step_by_hand if state.o.x.is_cuda else step_plain
    return step(scene, state, hit, miss, key, bounce_counter, rr)


def step_plain(scene, state: PathState, hit, miss: torch.Tensor,
               key: torch.Tensor, bounce_counter: int,
               rr: bool = False) -> PathState:
    """trace_step's shade, scatter and accumulate stages in plain torch,
    on the hits of the live lanes (done lanes: tri = -1); returns the
    new state."""
    o, d, att, rad = state.o, state.d, state.att, state.rad
    live = ~state.done

    with _profile.stage("shade"):
        sky = scene.sky_color
        # trace_ray.hpp:25-27
        res_miss = att * (V3(sky[0], sky[1], sky[2]) + rad)
        # shading data for hit lanes (garbage on miss lanes, masked)
        normal, uv_u, uv_v, mat = shade_lanes(scene, hit)
        rad_hit = rad + mat.emissive  # trace_ray.hpp:64
        res_absorb = att * rad_hit  # trace_ray.hpp:77-79

    with _profile.stage("scatter"):
        d_unit = normalize(d, eps=1e-20)
        cont, new_dir, s_att = mats.scatter(scene, mat, d_unit, normal,
                                            uv_u, uv_v, key, bounce_counter)

        hit_m = live & ~miss
        scat_m = hit_m & cont
        term_miss = live & miss
        term_abs = hit_m & ~cont

        new_att_s = att * s_att
        term_rr = torch.zeros_like(term_abs)
        if rr and bounce_counter - 2 >= RR_START:
            survive, att_rr = rr_survive(new_att_s, key, bounce_counter)
            term_rr = scat_m & ~survive
            new_att_s = where(scat_m & survive, att_rr, new_att_s)
            scat_m = scat_m & ~term_rr

        new_o = where(scat_m, o + d * hit.t, o)
        new_d = where(scat_m, new_dir, d)
        new_att = where(scat_m, new_att_s, att)
        new_rad = where(scat_m, rad_hit, rad)

    with _profile.stage("accumulate"):
        # an RR kill contributes like an absorb: att * radiance-so-far
        result = where(term_miss, res_miss,
                       where(term_abs | term_rr, res_absorb, state.result))
        done = state.done | term_miss | term_abs | term_rr
    return PathState(o=new_o, d=new_d, att=new_att, rad=new_rad,
                     result=result, done=done)


def step_by_hand(scene, state: PathState, hit, miss: torch.Tensor,
                 key: torch.Tensor, bounce_counter: int,
                 rr: bool = False) -> PathState:
    """trace_step's shade and scatter stages as one launch each
    (ops/vertex.py): the result and done updates are folded into the
    scatter, which updates `state` in place and returns it."""
    with _profile.stage("shade"):
        rec = _vertex.shade(scene, hit)
    with _profile.stage("scatter"):
        return _vertex.scatter(scene, rec, hit.t, miss, bounce_counter,
                               rr=rr, rr_start=RR_START, state=state,
                               key=key)
