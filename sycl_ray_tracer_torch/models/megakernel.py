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
from sycl_ray_tracer_torch.ops import rng as _rng
from sycl_ray_tracer_torch.ops.vec import V3, linear_to_gamma

# Lanes per wave: whole camera samples of the frame up to 8M lanes (the
# JAX engine's default wave); a frame larger than that runs one sample
# per wave.
WAVE_RAYS = 8 << 20


def _wave(scene, cam: Camera, seed: int, sample_offset: int, rays,
          *, width: int, height: int, max_depth: int, waves: int,
          rr: bool) -> torch.Tensor:
    """`waves` samples of every pixel from sample_offset on; adds the
    per-bounce tallies into rays [max_depth] (numpy int64) and returns
    the wave's linear color summed over its samples, [n, 3]."""
    dev = cam.center.device
    n = width * height
    lane = torch.arange(waves * n, dtype=torch.int64, device=dev)
    pix = lane % n
    key = _rng.make_key(_rng.make_key(seed, sample_offset + lane // n), pix)
    o, d = generate_rays(cam, pix % width, pix // width, key)
    zero = torch.zeros_like(o.x)
    one = torch.ones_like(o.x)
    st = _trace.PathState(o=o, d=d, att=V3(one, one, one),
                          rad=V3(zero, zero, zero),
                          result=V3(zero, zero, zero),
                          done=torch.zeros_like(o.x, dtype=torch.bool))
    for i in range(max_depth):
        live = int((~st.done).sum())
        if live == 0:
            break
        rays[i] += live
        st = _trace.trace_step(scene, st, key, i + 2, rr=rr)
    return torch.stack(st.result, dim=1).view(waves, n, 3).sum(dim=0)


def render_megakernel(scene, cam: Camera, *, width: int, height: int,
                      spp: int, max_depth: int, seed: int = 0,
                      rr: bool = False):
    """Returns (image [H, W, 3] float32 gamma-encoded on the scene's
    device, per-bounce ray counts [max_depth] int64 on the CPU)."""
    n = width * height
    waves = max(1, min(spp, WAVE_RAYS // n))
    acc = torch.zeros((n, 3), dtype=torch.float32, device=cam.center.device)
    rays = np.zeros((max_depth,), np.int64)
    s = 0
    while s < spp:
        w = min(waves, spp - s)
        acc += _wave(scene, cam, seed, s, rays, width=width, height=height,
                     max_depth=max_depth, waves=w, rr=rr)
        s += w
    img = linear_to_gamma(acc * (1.0 / spp))
    return img.reshape(height, width, 3), torch.from_numpy(rays)
