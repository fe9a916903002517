"""Wavefront renderer: bounce-synchronous compacted ray queues.

Parity target: render_wavefront.cpp (stages: generate_camera_rays :79,
shoot_rays :139, merge_samples :319, convert_image_to_srgb :360), and
the estimator of the JAX package's models/wavefront.py render_wavefront,
which this module reproduces ray for ray:

- the queue holds only live rays: generation fills it with every
  camera sample of a wave, and each bounce compacts the survivors into
  a prefix that becomes the next bounce's whole queue;
- terminated rays add their contribution into the pixel accumulator
  with index_add_ in the bounce that ends them;
- survivors are compacted by a stable argsort of the dir6_morton
  coherence key (direction octant, dominant axis, Morton cell of the
  new origin), which also groups similar rays for the next traversal;
- per-lane RNG keys are recomputed from the queue id and the wave's
  sample offset, so an image does not depend on how samples are cut
  into waves.

accumulate_wavefront renders any list of R pixels (px, py) and keys
each one on its `lane`, the pixel's id in the whole frame, so a shard
of the frame (parallel/mesh.py) draws the same (pixel, sample) streams
as one device; render_wavefront is accumulate_wavefront over every
pixel, then the gamma.

The queue is one [12, N] f32 tensor (origin, direction, attenuation,
radiance) plus q_id [N] int64 (sample * R + index into the R pixels).
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracer_torch.models import materials as mats
from sycl_ray_tracer_torch.models import trace as _trace
from sycl_ray_tracer_torch.models.camera import Camera, generate_rays
from sycl_ray_tracer_torch.ops import compact as _compact_ops
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops import vertex as _vertex
from sycl_ray_tracer_torch.ops.lbvh import morton30
from sycl_ray_tracer_torch.ops.vec import V3, linear_to_gamma, normalize, where
from sycl_ray_tracer_torch.utils import profile as _profile

_DEAD_KEY = 0xFFFFFFFF


def _coherence_key(scene, o: V3, d: V3) -> torch.Tensor:
    """dir6_morton sort key (int64 holding 32 bits): direction octant
    << 29 | dominant axis << 27 | Morton code of the origin >> 5."""
    oct_ = (((d.x < 0).to(torch.int64) << 2)
            | ((d.y < 0).to(torch.int64) << 1)
            | (d.z < 0).to(torch.int64))
    m = morton30(torch.stack([o.x, o.y, o.z], dim=-1), scene.scene_lo,
                 scene.scene_hi)
    ax, ay, az = d.x.abs(), d.y.abs(), d.z.abs()
    dom = torch.where(ax > ay, torch.where(ax > az, 0, 2),
                      torch.where(ay > az, 1, 2)).to(torch.int64)
    return (oct_ << 29) | (dom << 27) | (m >> 5)


def _compact(alive: torch.Tensor, sort_key: torch.Tensor) -> torch.Tensor:
    """Indices of the alive lanes, ordered by key (stable). Live keys
    are clamped one below the dead sentinel, so a live lane never sorts
    among the dead. The host reads the live count (the "live" wait of
    utils/profile.py:sync)."""
    key = torch.where(alive, torch.clamp(sort_key, max=_DEAD_KEY - 1),
                      _DEAD_KEY)
    order = torch.argsort(key, stable=True)
    live = alive.sum()
    with _profile.sync("live"):
        live = int(live)
    return order[:live]


def frame_pixels(width: int, height: int, device):
    """(px, py, lane) [width*height] int64 of every pixel of a frame, in
    row-major order: the pixel lists of the engines' accumulate_*."""
    lane = torch.arange(width * height, dtype=torch.int64, device=device)
    return lane % width, lane // width, lane


def _gen_queue(cam: Camera, seed: int, sample_offset: int, *, pixels,
               waves: int = 1):
    """generate_camera_rays stage (render_wavefront.cpp:79-127): `waves`
    camera samples of each of the R pixels (px, py, lane) = `pixels` in
    one queue of waves*R rays (q_id // R = sample within the wave, q_id
    % R = index into the pixels); each ray is keyed on (seed, sample,
    lane)."""
    px, py, lane = pixels
    r = lane.shape[0]
    q_id = torch.arange(waves * r, dtype=torch.int64, device=lane.device)
    idx = q_id % r
    sample_seed = _rng.make_key(seed, sample_offset + q_id // r)
    key = _rng.make_key(sample_seed, lane[idx])
    o, d = generate_rays(cam, px[idx], py[idx], key)
    q = torch.empty((12, waves * r), dtype=torch.float32, device=lane.device)
    q[0:3] = torch.stack(o)
    q[3:6] = torch.stack(d)
    q[6:9] = 1.0
    q[9:12] = 0.0
    return q, q_id


def _bounce(scene, q: torch.Tensor, q_id: torch.Tensor, bounce_idx: int,
            acc: torch.Tensor, seed: int, sample_offset: int,
            lane: torch.Tensor, rr: bool = False):
    """shoot_rays stage (render_wavefront.cpp:139-314) over the live
    queue q [12, N] / q_id [N] of R pixels keyed on lane [R]:
    intersect, shade, scatter, add the terminated rays into acc [R, 3]
    in place, and return the compacted survivors (q, q_id). Each stage
    runs in utils/profile.py:stage. On the card shade and scatter are
    one kernel each (_stages_by_hand) and the compaction a key pass, a
    sort and a gather (_compact_by_hand); on the CPU they are plain
    torch (_stages_plain, _compact_plain)."""
    o, d = V3(q[0], q[1], q[2]), V3(q[3], q[4], q[5])

    with _profile.stage("intersect"):
        hit = _trace.intersect_scene(scene, o, d)
        miss = hit.tri < 0

    stages = _stages_by_hand if q.is_cuda else _stages_plain
    lanes = [hit.t, *stages(scene, q, q_id, hit, miss, bounce_idx, acc, seed,
                            sample_offset, lane, rr)]
    del o, d, hit, miss
    compact = _compact_by_hand if q.is_cuda else _compact_plain
    with _profile.stage("compact"):
        return compact(scene, q, q_id, lanes)


def _compact_plain(scene, q, q_id, lanes):
    """The compact stage of _bounce in plain torch, on the lanes' [t,
    new_dir, new_att, rad_hit, terminated]: the survivors' rows (new
    origin o + d * t, new_dir, new_att, rad_hit) and q_id, in the order
    of _compact."""
    t, new_dir, new_att, rad_hit, terminated = lanes
    o, d = V3(q[0], q[1], q[2]), V3(q[3], q[4], q[5])
    new_o = o + d * t
    perm = _compact(~terminated, _coherence_key(scene, new_o, new_dir))
    q2 = torch.stack([*new_o, *new_dir, *new_att, *rad_hit])[:, perm]
    return q2, q_id[perm]


def _compact_by_hand(scene, q, q_id, lanes):
    """_compact_plain as one key pass, a stable radix sort of its 32-bit
    keys and one gather launch (ops/compact.py): the same next queue bit
    for bit. The key pass copies what the next queue needs into its
    records, so `lanes` is emptied after it: the bounce's hits and stage
    outputs are freed before the sort and the gather allocate. The host
    reads the live count once, after queueing the sort."""
    key, rec, stats = _compact_ops.keys(scene, q, q_id, *lanes)
    lanes.clear()
    perm = _compact_ops.sort(key, stats)
    del key
    with _profile.sync("live"):
        live = int(stats[0])
    return _compact_ops.gather(rec, perm[:live])


def _stages_plain(scene, q, q_id, hit, miss, bounce_idx, acc, seed,
                  sample_offset, lane, rr):
    """The shade, scatter and accumulate stages of _bounce in plain
    torch: add the terminated rays into acc and return (new_dir,
    new_att, rad_hit, terminated)."""
    n_pix = acc.shape[0]
    d = V3(q[3], q[4], q[5])
    att, rad = V3(q[6], q[7], q[8]), V3(q[9], q[10], q[11])

    with _profile.stage("shade"):
        sky = scene.sky_color
        res_miss = att * (V3(sky[0], sky[1], sky[2]) + rad)
        normal, uv_u, uv_v, mat = _trace.shade_lanes(scene, hit)
        rad_hit = rad + mat.emissive
        res_absorb = att * rad_hit

    with _profile.stage("scatter"):
        pix = q_id % n_pix
        key = _rng.make_key(
            _rng.make_key(seed, sample_offset + q_id // n_pix), lane[pix])
        d_unit = normalize(d, eps=1e-20)
        cont, new_dir, s_att = mats.scatter(scene, mat, d_unit, normal,
                                            uv_u, uv_v, key, bounce_idx + 2)
        new_att = att * s_att
        term_rr = torch.zeros_like(miss)
        if rr:
            survive, att_rr = _trace.rr_survive(new_att, key, bounce_idx + 2)
            if bounce_idx >= _trace.RR_START:
                term_rr = ~miss & cont & ~survive
                new_att = where(survive, att_rr, new_att)

    with _profile.stage("accumulate"):
        terminated = miss | ~cont | term_rr
        contrib = where(miss, res_miss, res_absorb)
        with _profile.sync("terminated"):
            t_idx = terminated.nonzero().squeeze(1)
        acc.index_add_(0, pix[t_idx], torch.stack(contrib, dim=1)[t_idx])
    return new_dir, new_att, rad_hit, terminated


def _stages_by_hand(scene, q, q_id, hit, miss, bounce_idx, acc, seed,
                    sample_offset, lane, rr):
    """_stages_plain as one shade and one scatter launch
    (ops/vertex.py), which key each lane from (seed, sample_offset,
    q_id, lane) in the kernel; the accumulate stage adds their
    contributions."""
    with _profile.stage("shade"):
        rec = _vertex.shade(scene, hit)

    with _profile.stage("scatter"):
        out, terminated, contrib = _vertex.scatter(
            scene, rec, hit.t, miss, bounce_idx + 2, rr=rr,
            rr_start=_trace.RR_START, q=q, q_id=q_id, lane=lane, seed=seed,
            sample_offset=sample_offset)
        del rec

    with _profile.stage("accumulate"):
        with _profile.sync("terminated"):
            t_idx = terminated.nonzero().squeeze(1)
        acc.index_add_(0, q_id[t_idx] % acc.shape[0], contrib[t_idx])
    return V3(*out[0:3]), V3(*out[3:6]), V3(*out[6:9]), terminated


def _wave_samples(spp: int, n: int) -> int:
    """Camera samples per wave for an n-pixel frame: the whole frame
    when spp*n <= 68M rays, else as many as fit in 64M rays."""
    wave_rays = spp * n if spp * n <= (68 << 20) else 64 << 20
    return max(1, min(spp, wave_rays // n))


def accumulate_wavefront(scene, cam: Camera, px: torch.Tensor,
                         py: torch.Tensor, lane: torch.Tensor, *, spp: int,
                         max_depth: int, seed: int, sample_offset: int = 0,
                         rr: bool = False):
    """The linear color of the R pixels (px, py) [R] int64, summed over
    samples sample_offset .. sample_offset + spp - 1, each pixel keyed
    on lane [R] (its id in the whole frame). Returns (sum [R, 3] f32 on
    the camera's device, per-bounce ray counts [max_depth] int64 on the
    CPU).

    Samples are batched into waves: one wave when spp*R <= 68M rays,
    else 64M-ray waves. The bounce loop is host-driven; the host reads
    one live count per bounce (render_wavefront.cpp:144)."""
    r = lane.shape[0]
    waves = _wave_samples(spp, r)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=lane.device)
    rays = np.zeros((max_depth,), np.int64)
    s = 0
    while s < spp:
        w = min(waves, spp - s)
        with _profile.stage("generate"):
            q, q_id = _gen_queue(cam, seed, sample_offset + s,
                                 pixels=(px, py, lane), waves=w)
        for bounce in range(max_depth):
            n = q_id.numel()
            if n == 0:
                break
            rays[bounce] += n
            q, q_id = _bounce(scene, q, q_id, bounce, acc, seed,
                              sample_offset + s, lane, rr=rr)
        s += w
    return acc, torch.from_numpy(rays)


def render_wavefront(scene, cam: Camera, *, width: int, height: int,
                     spp: int, max_depth: int, seed: int = 0,
                     rr: bool = False):
    """Returns (image [H, W, 3] float32 gamma-encoded on the scene's
    device, per-bounce ray counts [max_depth] int64 on the CPU)."""
    acc, rays = accumulate_wavefront(
        scene, cam, *frame_pixels(width, height, cam.center.device),
        spp=spp, max_depth=max_depth, seed=seed, rr=rr)
    img = linear_to_gamma(acc * (1.0 / spp))
    return img.reshape(height, width, 3), rays
