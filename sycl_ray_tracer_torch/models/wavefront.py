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

The queue is one [12, N] f32 tensor (origin, direction, attenuation,
radiance) plus q_id [N] int64 (sample * n_pixels + pixel).
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracer_torch.models import materials as mats
from sycl_ray_tracer_torch.models import trace as _trace
from sycl_ray_tracer_torch.models.camera import Camera, generate_rays
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.lbvh import morton30
from sycl_ray_tracer_torch.ops.vec import V3, linear_to_gamma, normalize, where

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
    among the dead."""
    key = torch.where(alive, torch.clamp(sort_key, max=_DEAD_KEY - 1),
                      _DEAD_KEY)
    return torch.argsort(key, stable=True)[:int(alive.sum())]


def _gen_queue(cam: Camera, seed: int, sample_offset: int, *, width: int,
               height: int, waves: int = 1):
    """generate_camera_rays stage (render_wavefront.cpp:79-127): `waves`
    camera samples of every pixel in one queue of waves*W*H rays
    (lane // n = sample within the wave, lane % n = pixel)."""
    dev = cam.center.device
    n = width * height
    lane = torch.arange(waves * n, dtype=torch.int64, device=dev)
    pix = lane % n
    sample_seed = _rng.make_key(seed, sample_offset + lane // n)
    key = _rng.make_key(sample_seed, pix)
    o, d = generate_rays(cam, pix % width, pix // width, key)
    q = torch.empty((12, waves * n), dtype=torch.float32, device=dev)
    q[0:3] = torch.stack(o)
    q[3:6] = torch.stack(d)
    q[6:9] = 1.0
    q[9:12] = 0.0
    return q, lane


def _bounce(scene, q: torch.Tensor, q_id: torch.Tensor, bounce_idx: int,
            acc: torch.Tensor, seed: int, sample_offset: int,
            rr: bool = False):
    """shoot_rays stage (render_wavefront.cpp:139-314) over the live
    queue q [12, N] / q_id [N]: intersect, shade, scatter, add the
    terminated rays into acc [n_pixels, 3] in place, and return the
    compacted survivors (q, q_id)."""
    n_pix = acc.shape[0]
    o, d = V3(q[0], q[1], q[2]), V3(q[3], q[4], q[5])
    att, rad = V3(q[6], q[7], q[8]), V3(q[9], q[10], q[11])
    pix = q_id % n_pix
    key = _rng.make_key(_rng.make_key(seed, sample_offset + q_id // n_pix),
                        pix)

    hit = _trace.intersect_scene(scene, o, d)
    miss = hit.tri < 0

    sky = scene.sky_color
    res_miss = att * (V3(sky[0], sky[1], sky[2]) + rad)

    normal, uv_u, uv_v, mat = _trace.shade_lanes(scene, hit)
    rad_hit = rad + mat.emissive
    d_unit = normalize(d, eps=1e-20)
    cont, new_dir, s_att = mats.scatter(scene, mat, d_unit, normal,
                                        uv_u, uv_v, key, bounce_idx + 2)
    res_absorb = att * rad_hit

    new_att = att * s_att
    term_rr = torch.zeros_like(miss)
    if rr:
        survive, att_rr = _trace.rr_survive(new_att, key, bounce_idx + 2)
        if bounce_idx >= _trace.RR_START:
            term_rr = ~miss & cont & ~survive
            new_att = where(survive, att_rr, new_att)

    terminated = miss | ~cont | term_rr
    contrib = where(miss, res_miss, res_absorb)
    t_idx = terminated.nonzero().squeeze(1)
    acc.index_add_(0, pix[t_idx], torch.stack(contrib, dim=1)[t_idx])

    new_o = o + d * hit.t
    perm = _compact(~terminated, _coherence_key(scene, new_o, new_dir))
    q2 = torch.stack([*new_o, *new_dir, *new_att, *rad_hit])[:, perm]
    return q2, q_id[perm]


def _wave_samples(spp: int, n: int) -> int:
    """Camera samples per wave for an n-pixel frame: the whole frame
    when spp*n <= 68M rays, else as many as fit in 64M rays."""
    wave_rays = spp * n if spp * n <= (68 << 20) else 64 << 20
    return max(1, min(spp, wave_rays // n))


def render_wavefront(scene, cam: Camera, *, width: int, height: int,
                     spp: int, max_depth: int, seed: int = 0,
                     rr: bool = False):
    """Returns (image [H, W, 3] float32 gamma-encoded on the scene's
    device, per-bounce ray counts [max_depth] int64 on the CPU).

    Samples are batched into waves: one wave when spp*W*H <= 68M rays,
    else 64M-ray waves. The bounce loop is host-driven; the host reads
    one live count per bounce (render_wavefront.cpp:144)."""
    n = width * height
    waves = _wave_samples(spp, n)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=cam.center.device)
    rays = np.zeros((max_depth,), np.int64)
    s = 0
    while s < spp:
        w = min(waves, spp - s)
        q, q_id = _gen_queue(cam, seed, s, width=width, height=height,
                             waves=w)
        for bounce in range(max_depth):
            if q_id.numel() == 0:
                break
            rays[bounce] += q_id.numel()
            q, q_id = _bounce(scene, q, q_id, bounce, acc, seed, s, rr=rr)
        s += w
    img = linear_to_gamma(acc * (1.0 / spp))
    return img.reshape(height, width, 3), torch.from_numpy(rays)
