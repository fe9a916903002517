"""Megakernel renderer: every lane of a wave walks its path to the end.

Parity target: render_megakernel.cpp:20-63, 75-187 (one thread per
pixel sample with the bounce loop inside), and the estimator of the JAX
package's models/megakernel.py render_megakernel as it runs off the TPU
(sort_every = 0, no chunking), which this module reproduces ray for
ray:

- a wave holds `w` camera samples of every pixel: lane // n is the
  sample within the wave and lane % n the pixel, and each lane's RNG
  key comes from (seed, absolute sample index, pixel), so any cut of
  the samples into waves renders the same paths;
- each bounce runs trace_step (models/trace.py) over the whole wave, with
  the done lanes masked out of the intersection; the bounce counter of
  bounce i is i + 2 (counters 0 and 1 are the camera jitter);
- the ray tally of bounce i counts the lanes still live at its top;
- the loop ends at max_depth or when every lane is done; a path still
  live at max_depth contributes black, and max_depth = 0 renders black
  with no rays.

accumulate_megakernel renders any list of R pixels, keyed on their ids
in the whole frame, as models/wavefront.py:accumulate_wavefront does;
render_megakernel is accumulate_megakernel over every pixel, then the
gamma.

The engines compute the same function per path; only the order of the
float sums into a pixel differs, so the megakernel matches
models/wavefront.py to float noise with equal tallies. The TPU
scheduling of the JAX engine (the peeled primary bounce, the coherence
re-sort, bounce chunking, the watchdog cap) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracer_torch.models import trace as _trace
from sycl_ray_tracer_torch.models.camera import Camera, generate_rays
from sycl_ray_tracer_torch.models.wavefront import frame_pixels
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.vec import linear_to_gamma
from sycl_ray_tracer_torch.utils import profile as _profile

# Lanes per wave: whole camera samples of the pixels up to 8M lanes (the
# JAX engine's default wave); more pixels than that run one sample per
# wave.
WAVE_RAYS = 8 << 20


def _wave(scene, cam: Camera, seed: int, sample_offset: int, rays,
          *, pixels, max_depth: int, waves: int, rr: bool) -> torch.Tensor:
    """`waves` samples of each of the R pixels (px, py, lane) = `pixels`
    from sample_offset on; adds the per-bounce tallies into rays
    [max_depth] (numpy int64) and returns the wave's linear color summed
    over its samples, [R, 3]."""
    px, py, lane = pixels
    r = lane.shape[0]
    with _profile.stage("generate"):
        ids = torch.arange(waves * r, dtype=torch.int64, device=lane.device)
        idx = ids % r
        key = _rng.make_key(_rng.make_key(seed, sample_offset + ids // r),
                            lane[idx])
        st = _trace.start_state(*generate_rays(cam, px[idx], py[idx], key))
    for i in range(max_depth):
        with _profile.stage("count"):
            live = (~st.done).sum()
            with _profile.sync("live"):
                live = int(live)
        if live == 0:
            break
        rays[i] += live
        st = _trace.trace_step(scene, st, key, i + 2, rr=rr)
    with _profile.stage("accumulate"):
        return torch.stack(st.result, dim=1).view(waves, r, 3).sum(dim=0)


def accumulate_megakernel(scene, cam: Camera, px: torch.Tensor,
                          py: torch.Tensor, lane: torch.Tensor, *, spp: int,
                          max_depth: int, seed: int, sample_offset: int = 0,
                          rr: bool = False):
    """The linear color of the R pixels (px, py) [R] int64, summed over
    samples sample_offset .. sample_offset + spp - 1, each pixel keyed
    on lane [R] (its id in the whole frame). Returns (sum [R, 3] f32 on
    the camera's device, per-bounce ray counts [max_depth] int64 on the
    CPU)."""
    r = lane.shape[0]
    waves = max(1, min(spp, WAVE_RAYS // r))
    acc = torch.zeros((r, 3), dtype=torch.float32, device=lane.device)
    rays = np.zeros((max_depth,), np.int64)
    s = 0
    while s < spp:
        w = min(waves, spp - s)
        acc += _wave(scene, cam, seed, sample_offset + s, rays,
                     pixels=(px, py, lane), max_depth=max_depth, waves=w,
                     rr=rr)
        s += w
    return acc, torch.from_numpy(rays)


def render_megakernel(scene, cam: Camera, *, width: int, height: int,
                      spp: int, max_depth: int, seed: int = 0,
                      rr: bool = False):
    """Returns (image [H, W, 3] float32 gamma-encoded on the scene's
    device, per-bounce ray counts [max_depth] int64 on the CPU)."""
    acc, rays = accumulate_megakernel(
        scene, cam, *frame_pixels(width, height, cam.center.device),
        spp=spp, max_depth=max_depth, seed=seed, rr=rr)
    img = linear_to_gamma(acc * (1.0 / spp))
    return img.reshape(height, width, 3), rays
