"""CPU oracle: a slow, trivially-correct numpy path tracer.

It shares the exact estimator with the port's renderers and the JAX
package's: the same counter-based RNG bits, camera jitter, scatter
models and termination algebra (trace_ray.hpp semantics), but with
brute-force intersection (ops/intersect.py:intersect_brute_np) and
plain numpy, so any disagreement beyond float-accumulation noise is a
fault in the fast path. It equals the JAX package's models/oracle.py
bit for bit, imports no jax, and runs on the host whatever device the
camera lives on, so a card's renders can be gated against it on a
machine without jax.
"""

from __future__ import annotations

import numpy as np

from sycl_ray_tracer_torch.models.camera import Camera, generate_rays_np
from sycl_ray_tracer_torch.models.trace import RR_FLOOR, RR_START
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.intersect import intersect_brute_np
from sycl_ray_tracer_torch.ops.sampling import random_unit_vector_np
from sycl_ray_tracer_torch.utils.gltf import (MAT_DIELECTRIC, MAT_DIFFUSE,
                                              MAT_METALLIC, HostScene)

_U32 = np.uint32


def _normalize(v, eps=1e-20):
    n = np.sqrt((v * v).sum(-1, keepdims=True) + eps)
    return v / n


def _reflect(v, n):
    return v - 2.0 * (v * n).sum(-1, keepdims=True) * n


def _refract(uv, n, ratio):
    cos_theta = np.minimum(-(uv * n).sum(-1, keepdims=True), 1.0)
    r_out_perp = ratio[:, None] * (uv + cos_theta * n)
    par = -np.sqrt(np.abs(1.0 - (r_out_perp ** 2).sum(-1, keepdims=True)))
    return r_out_perp + par * n


def _sample_texture_np(textures, tex, u, v):
    res = textures.shape[1]
    # f32->int32 with saturation, matching the renderers' convert (int64
    # modulo would pick a different texel for |u*res| >= 2^31
    # extreme/malformed UVs)
    i32max = np.float64(2 ** 31 - 1)
    x = np.clip(np.floor(u * res), -i32max - 1,
                i32max).astype(np.int32) % res
    y = np.clip(np.floor(v * res), -i32max - 1,
                i32max).astype(np.int32) % res
    t = np.maximum(tex, 0).astype(np.int64)
    texel = textures[t, y, x].astype(np.float32) / np.float32(255.0)
    return texel[..., :3]


def render_oracle(host: HostScene, cam: Camera, *, width: int, height: int,
                  spp: int, max_depth: int, seed: int = 0,
                  rr: bool = False) -> np.ndarray:
    """Returns the gamma-encoded [H, W, 3] float32 image. rr enables
    russian-roulette termination, mirroring trace.rr_survive bit for bit
    (BASELINE config 3)."""
    n = width * height
    lane = np.arange(n, dtype=_U32)
    px = (lane % _U32(width)).astype(np.int32)
    py = (lane // _U32(width)).astype(np.int32)

    m = host.materials
    tri_v = host.tri_v
    sky = host.sky_color.astype(np.float32)

    accum = np.zeros((n, 3), np.float32)

    for s in range(spp):
        key = _rng.make_key_np(_rng.make_key_np(_U32(seed), _U32(s)), lane)
        o, d = generate_rays_np(cam, px, py, key)
        att = np.ones((n, 3), np.float32)
        rad = np.zeros((n, 3), np.float32)
        result = np.zeros((n, 3), np.float32)
        done = np.zeros(n, bool)

        for bounce in range(max_depth):
            live = ~done
            if not live.any():
                break
            t, tri, u, v = intersect_brute_np(o[live], d[live], tri_v)
            li = np.nonzero(live)[0]

            miss = tri < 0
            # miss: attenuation * (sky + radiance)
            mi = li[miss]
            result[mi] = att[mi] * (sky[None, :] + rad[mi])
            done[mi] = True

            hi = li[~miss]
            if hi.size == 0:
                continue
            th = t[~miss][:, None]
            trih = tri[~miss]
            uh = u[~miss][:, None]
            vh = v[~miss][:, None]
            wh = 1.0 - uh - vh

            nrm = host.tri_n[trih]
            ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(ln, 1e-20)
            normal = _normalize(wh * nrm[:, 0] + uh * nrm[:, 1] + vh * nrm[:, 2])
            uvs = host.tri_uv[trih]
            uv_u = (wh * uvs[:, 0:1, 0] + uh * uvs[:, 1:2, 0]
                    + vh * uvs[:, 2:3, 0])[:, 0]
            uv_v = (wh * uvs[:, 0:1, 1] + uh * uvs[:, 1:2, 1]
                    + vh * uvs[:, 2:3, 1])[:, 0]

            mid = host.tri_mat[trih]
            mtype = m.mtype[mid]
            rad[hi] += m.emissive[mid]

            d_unit = _normalize(d[hi])
            keyh = key[hi]
            ctr = _U32(bounce + 2)
            ruv = random_unit_vector_np(keyh, ctr)
            with np.errstate(over="ignore"):
                u1 = _rng.uniform_np(keyh, ctr + _U32(0x55555555))

            albedo = m.albedo[mid].copy()
            has_tex = m.tex_id[mid] >= 0
            if has_tex.any():
                albedo[has_tex] = _sample_texture_np(
                    host.textures, m.tex_id[mid][has_tex],
                    uv_u[has_tex], uv_v[has_tex])

            # diffuse
            dir_diff = normal + ruv
            nz = (np.abs(dir_diff) < 1e-8).all(-1)
            dir_diff[nz] = normal[nz]
            # metallic
            refl = _reflect(d_unit, normal)
            dir_met = refl + m.roughness[mid][:, None] * ruv
            ok_met = (dir_met * normal).sum(-1) > 0
            # dielectric
            front = (d_unit * normal).sum(-1) < 0
            n_face = np.where(front[:, None], normal, -normal)
            ratio = np.where(front, 1.0 / m.ior[mid], m.ior[mid])
            cos_t = np.minimum(-(d_unit * n_face).sum(-1), 1.0)
            sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
            cannot = ratio * sin_t > 1.0
            # multiply chains, not **: numpy pow may round differently
            # from the renderers' m2*m2*m Schlick term, and a 1-ulp flip
            # at the schlick>u1 boundary decorrelates the whole path
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            omc = 1.0 - cos_t
            omc2 = omc * omc
            schlick = r0 + (1.0 - r0) * (omc2 * omc2 * omc)
            do_refl = cannot | (schlick > u1)
            dir_diel = np.where(do_refl[:, None], _reflect(d_unit, n_face),
                                _refract(d_unit, n_face, ratio))

            is_diff = mtype == MAT_DIFFUSE
            is_met = mtype == MAT_METALLIC
            is_diel = mtype == MAT_DIELECTRIC
            new_dir = np.where(is_diff[:, None], dir_diff,
                               np.where(is_met[:, None], dir_met, dir_diel))
            atten = np.where(is_diel[:, None], 1.0, albedo).astype(np.float32)
            cont = np.where(is_met, ok_met, is_diff | is_diel)

            # absorbed lanes terminate with att * rad
            ai = hi[~cont]
            result[ai] = att[ai] * rad[ai]
            done[ai] = True

            boost = None
            if rr and bounce >= RR_START:
                new_att = att[hi] * atten
                p = np.clip(new_att.max(axis=1), RR_FLOOR, 1.0)
                with np.errstate(over="ignore"):
                    u = _rng.uniform_np(keyh, ctr + _U32(0x33333333))
                survive = u < p
                killed = cont & ~survive
                ki = hi[killed]
                result[ki] = att[ki] * rad[ki]
                done[ki] = True
                cont = cont & survive
                boost = (1.0 / p)[:, None]

            si = hi[cont]
            o[si] = o[si] + d[si] * th[cont]
            d[si] = new_dir[cont]
            if boost is None:
                att[si] = att[si] * atten[cont]
            else:
                # (att*atten) * (1/p) in THIS order: trace.rr_survive
                # computes the new attenuation first, then scales;
                # folding the boost into atten would round differently
                # (f32 mult is non-associative) and flip the next
                # bounce's kill boundary against the renderers
                att[si] = (att[si] * atten[cont]) * boost[cont]

        accum += result

    img = np.sqrt(np.maximum(accum / spp, 0.0))
    return img.reshape(height, width, 3).astype(np.float32)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64)
                                  - b.astype(np.float64)) ** 2)))
