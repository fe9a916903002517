"""The plain reference renderer: any list of pixels of a frame, worked
out on their own in plain torch, for the comparison that decides a
run's `correct`.

The estimator is the upstream renderer's (felipeagc/sycl-ray-tracer,
camera.hpp, trace_ray.hpp, material.hpp), with the port's keyed RNG:

- camera: basis from world up (0, 1, 0), viewport height 2 (from -1 to
  1) and width 2 * aspect at the focal length; a sample of pixel (x, y)
  aims at pixel00 + (x + jx) du + (y + jy) dv, with jitter in
  [-0.5, 0.5) from counters 0 and 1, and its direction is left
  unnormalized;
- a miss ends the path with att * (sky + rad); a hit adds the
  material's emission to rad and scatters: diffuse to normal + a unit
  vector (the normal where that is near zero), metal to reflect + rough
  * unit vector (absorbed when it points into the surface), dielectric
  by Snell with Schlick's reflectance against a uniform draw; an
  absorbed path ends with att * rad; the scattered ray starts at
  o + t d, and att is multiplied by the albedo (1 for a dielectric);
  a path still live after max_depth bounces adds black;
- albedo comes from the material, or from its texture: nearest texel,
  repeat-wrapped, bytes / 255;
- the image is sqrt(max(sum / spp, 0)) of each pixel's sum over its
  samples.

The per-bounce tallies count the paths live at the top of each bounce.
`state_dtype` rounds the path state (origin, direction, attenuation,
radiance) to a lower precision after every bounce: the control that a
check must refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from srt_bench.reference import rng
from srt_bench.reference.bvh import Bvh, _dot
from srt_bench.reference.ingest import (MAT_DIELECTRIC, MAT_DIFFUSE,
                                        MAT_METALLIC, RefScene)

MAX_PATHS = 1 << 21


class DeviceRef:
    """A RefScene's tables on a device, with its own LBVH."""

    def __init__(self, s: RefScene, device):
        def dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), device=device,
                                   dtype=dtype)

        self.bvh = Bvh(dev(s.tri_v, torch.float32))
        self.tri_n = dev(s.tri_n).reshape(-1, 9)
        self.tri_uv = dev(s.tri_uv).reshape(-1, 6)
        self.tri_mat = dev(s.tri_mat)
        self.mtype = dev(s.mtype)
        self.albedo = dev(s.albedo)
        self.tex_id = dev(s.tex_id)
        self.rough = dev(s.rough)
        self.ior = dev(s.ior)
        self.emissive = dev(s.emissive)
        self.textures = dev(s.textures[..., :3])
        self.tex_res = s.textures.shape[1]
        self.sky = dev(s.sky)
        self.s = s


def camera(s: RefScene, width: int, height: int, device):
    """(center, pixel00, du, dv), each [3] f32, computed in float64."""
    d = s.cam_dir / max(np.linalg.norm(s.cam_dir), 1e-20)
    right = np.cross(d, [0.0, 1.0, 0.0])
    right = right / max(np.linalg.norm(right), 1e-20)
    up = np.cross(right, d)
    up = up / max(np.linalg.norm(up), 1e-20)
    vw = float(width) / float(height)
    p00 = s.cam_pos - right * vw + up + d * s.focal
    du = right * (2.0 * vw / width)
    dv = -up * (2.0 / height)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in (s.cam_pos, p00, du, dv))


def _normalize(v):
    return v * torch.rsqrt(_dot(v, v) + 1e-20)[:, None]


def _reflect(v, n):
    return v - n * (2.0 * _dot(v, n))[:, None]


def _refract(uv, n, ratio):
    cos_t = torch.clamp(_dot(-uv, n), max=1.0)
    perp = (uv + n * cos_t[:, None]) * ratio[:, None]
    par = -torch.sqrt(torch.abs(1.0 - _dot(perp, perp)))
    return perp + n * par[:, None]


def _unit_vector(key, counter):
    u, v, w = rng.uniform3(key, counter)
    return _normalize(torch.stack([u * 2.0 - 1.0, v * 2.0 - 1.0,
                                   w * 2.0 - 1.0], 1))


def _texel(c, res):
    f = torch.floor(c * res).to(torch.float64).clamp(-2.0 ** 31,
                                                     2.0 ** 31 - 1)
    return f.to(torch.int64) % res


def _bounce(sc: DeviceRef, o, d, att, rad, key, counter):
    """One path vertex of live rays. Returns (continues [N] bool, the
    result of a path that ends here (a miss or an absorb) [N, 3], and the
    next o, d, att, rad of the rays that continue)."""
    t, tri, hu, hv = sc.bvh.intersect(o, d)
    miss = tri < 0
    res_miss = att * (sc.sky + rad)
    tri = tri.clamp(min=0)
    w = 1.0 - hu - hv
    c = sc.tri_n[tri]
    nrm = _normalize(torch.stack([
        w * c[:, j] + hu * c[:, 3 + j] + hv * c[:, 6 + j] for j in range(3)],
        1))
    uvt = sc.tri_uv[tri]
    uu = w * uvt[:, 0] + hu * uvt[:, 2] + hv * uvt[:, 4]
    vv = w * uvt[:, 1] + hu * uvt[:, 3] + hv * uvt[:, 5]
    mid = sc.tri_mat[tri]
    mtype = sc.mtype[mid]
    rad_hit = rad + sc.emissive[mid]
    res_abs = att * rad_hit

    d_unit = _normalize(d)
    ruv = _unit_vector(key, counter)
    u1 = rng.uniform(key, counter + 0x55555555)
    tex = sc.tex_id[mid]
    res = sc.tex_res
    texel = sc.textures[tex.clamp(min=0), _texel(vv, res), _texel(uu, res)]
    albedo = torch.where((tex >= 0)[:, None],
                         texel.to(torch.float32) * (1.0 / 255.0),
                         sc.albedo[mid])

    dir_diff = nrm + ruv
    dir_diff = torch.where((dir_diff.abs() < 1e-8).all(1)[:, None], nrm,
                           dir_diff)
    dir_met = _reflect(d_unit, nrm) + ruv * sc.rough[mid][:, None]
    ok_met = _dot(dir_met, nrm) > 0.0
    ior = sc.ior[mid]
    front = _dot(d_unit, nrm) < 0.0
    n_face = torch.where(front[:, None], nrm, -nrm)
    ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(_dot(-d_unit, n_face), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    m = 1.0 - cos_t
    m2 = m * m
    reflects = (ratio * sin_t > 1.0) | (r0 + (1.0 - r0) * (m2 * m2 * m) > u1)
    dir_diel = torch.where(reflects[:, None], _reflect(d_unit, n_face),
                           _refract(d_unit, n_face, ratio))

    is_diff, is_met = mtype == MAT_DIFFUSE, mtype == MAT_METALLIC
    is_diel = mtype == MAT_DIELECTRIC
    new_d = torch.where(is_diff[:, None], dir_diff,
                        torch.where(is_met[:, None], dir_met, dir_diel))
    atten = torch.where(is_diel[:, None], torch.ones_like(albedo), albedo)
    cont = ~miss & torch.where(is_met, ok_met, is_diff | is_diel)
    result = torch.where(miss[:, None], res_miss, res_abs)
    new_o = o + d * t[:, None]
    return cont, result, new_o, new_d, att * atten, rad_hit


def render_pixels(sc: DeviceRef, cam, px, py, *, width: int, spp: int,
                  max_depth: int, seed: int, state_dtype=None):
    """Gamma-encoded colors [P, 3] f32 of the pixels (px, py) [P] int64
    of a width-wide frame, over samples 0 .. spp - 1 of frame seed
    `seed`, and the per-bounce tallies [max_depth] int64 of their paths.
    At most MAX_PATHS paths are in flight at once."""
    dev = px.device
    p = px.shape[0]
    lane = py * width + px
    center, p00, du, dv = cam
    acc = torch.zeros((p, 3), device=dev)
    tallies = torch.zeros((max_depth,), dtype=torch.int64)
    per = max(1, min(spp, MAX_PATHS // max(p, 1)))
    for s0 in range(0, spp, per):
        w = min(per, spp - s0)
        ids = torch.arange(w * p, device=dev)
        pix = ids % p
        key = rng.make_key(rng.make_key(seed, s0 + ids // p), lane[pix])
        fx = px[pix].to(torch.float32) + (rng.uniform(key, 0) - 0.5)
        fy = py[pix].to(torch.float32) + (rng.uniform(key, 1) - 0.5)
        d = (p00[None] + fx[:, None] * du[None] + fy[:, None] * dv[None]
             - center[None])
        o = center.expand_as(d).contiguous()
        att = torch.ones_like(d)
        rad = torch.zeros_like(d)
        live = torch.arange(w * p, device=dev)
        for b in range(max_depth):
            if live.numel() == 0:
                break
            tallies[b] += live.numel()
            cont, result, o, d, att, rad = _bounce(
                sc, o, d, att, rad, key[live], b + 2)
            ended = ~cont
            acc.index_add_(0, pix[live[ended]], result[ended])
            live = live[cont]
            o, d, att, rad = o[cont], d[cont], att[cont], rad[cont]
            if state_dtype is not None:
                o, d, att, rad = (x.to(state_dtype).to(torch.float32)
                                  for x in (o, d, att, rad))
    img = torch.sqrt(torch.clamp(acc * (1.0 / spp), min=0.0))
    return img, tallies
