#!/usr/bin/env python
"""Headline benchmark of the PyTorch port: the procedural Sponza
(sponza_proc), wavefront engine, 1024x1024, 64 spp, depth 10, as
bench.py runs it through the JAX package.

    python3 bench_torch.py                  # on the card
    python3 bench_torch.py --device cpu     # plain torch on the CPU

Settings from the environment, with bench.py's names and defaults:
BENCH_SCENE_SCALE (2), BENCH_RES (1024), BENCH_SPP (64), BENCH_DEPTH
(10), BENCH_RUNS (3).

One warm-up frame on seed RUNS (outside the timed range), then RUNS
frames on seeds 0..RUNS-1, each timed as the CLI times a frame
(utils/cli.py:timed_frame: synchronize, render, synchronize). Scene
generation and the BVH build are set-up and are not timed.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": median Mrays/s, "unit": "Mrays/s",
   "median", "mean", "runs": [Mrays/s per run], "n_runs", "spread":
   max - min, "totals": [rays per run], "device"}
`value` is the median of the runs (bench.py reports the mean, which is
kept under "mean"). bench.py's vs_baseline is not carried over: its
200 Mrays/s is a TPU target. `metric` names the backend and, on the
card, the card's name and power limit. Without CUDA the script exits
non-zero unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

SPP = int(os.environ.get("BENCH_SPP", 64))
DEPTH = int(os.environ.get("BENCH_DEPTH", 10))
RES = int(os.environ.get("BENCH_RES", 1024))
RUNS = int(os.environ.get("BENCH_RUNS", 3))
SCALE = int(os.environ.get("BENCH_SCENE_SCALE", 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: CUDA is not available; pass --device cpu "
                         "to run on the CPU")
    device = torch.device(args.device)

    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.models.scene import build_device_scene
    from sycl_ray_tracer_torch.models.wavefront import render_wavefront
    from sycl_ray_tracer_torch.utils.cli import card_label, timed_frame
    from sycl_ray_tracer_torch.utils.gltf import load_glb
    from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb

    # device bring-up is not scene build (as bench.py's jax.devices())
    label = card_label(device)
    if device.type == "cuda":
        torch.cuda.init()

    t0 = time.perf_counter()
    host = load_glb(sponza_like_glb(scale=SCALE))
    scene = build_device_scene(host, device=device)
    cam = make_camera(RES, RES, host.camera_position, host.camera_direction,
                      host.camera_focal_length, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"# scene: {host.num_triangles} tris, build "
          f"{time.perf_counter() - t0:.3f}s, device {label}", file=sys.stderr)

    def run(seed):
        return render_wavefront(scene, cam, width=RES, height=RES, spp=SPP,
                                max_depth=DEPTH, seed=seed)

    # warm-up (kernel library load, allocator growth), discarded like the
    # reference's run 0, on a seed outside the measured range
    timed_frame(lambda: run(RUNS), device)

    rates, totals = [], []
    for i in range(RUNS):
        (_, rays), dt = timed_frame(lambda: run(i), device)
        total = int(rays.sum())
        rates.append(total / dt / 1e6)
        totals.append(total)
        print(f"# run {i}: {total} rays in {dt:.6f}s = {rates[-1]:.4f} "
              f"Mrays/s", file=sys.stderr)

    backend = (f"torch cuda on {label}" if device.type == "cuda"
               else "torch cpu")
    median = statistics.median(rates)
    print(json.dumps({
        "metric": f"Mrays/s sponza_proc({host.num_triangles}tris) "
                  f"wavefront {RES}x{RES} spp{SPP} d{DEPTH}, {backend}",
        "value": median,
        "unit": "Mrays/s",
        "median": median,
        "mean": statistics.mean(rates),
        "runs": rates,
        "n_runs": RUNS,
        "spread": max(rates) - min(rates),
        "totals": totals,
        "device": label,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
