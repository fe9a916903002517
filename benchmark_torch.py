#!/usr/bin/env python
"""Benchmark sweep of the PyTorch port: benchmark.py (the reference's
sweep harness) through sycl_ray_tracer_torch.

Runs a {scene} x {resolution} x {(depth, samples)} x {renderer} matrix,
discards run 0 of each config (kernel library load and allocator
growth, the analog of the reference's SYCL JIT warm-up), varies the
seed per run, and writes benchmark_torch_raw.csv and
benchmark_torch_avg.csv in the working directory, with the columns of
benchmark.py's CSVs (which this script never reads or writes).

    python3 benchmark_torch.py --inproc                 # on the card
    python3 benchmark_torch.py --inproc --device cpu --scenes cube \\
        --pairs 3:2 --resolutions 32x24                 # on the CPU

Subprocess mode (the default) runs one CLI process per run,
`python -m sycl_ray_tracer_torch ... --seed r`, and scrapes its three
contract lines; each run then times its process's first frame.
--inproc renders in this process (each scene loaded once, every frame
timed by the CLI's utils/cli.py:timed_frame). --devices N passes
--devices N to the CLI in subprocess mode; --inproc refuses it.
--shared-instances renders two-level (the CLI's flag; the JAX sweep
reads SRT_SHARED_INSTANCES=1), and its rows name the scene
"<scene>+shared". Without CUDA the sweep exits non-zero unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import statistics
import subprocess
import sys

RAYS_RE = re.compile(r"Rays/sec: ([0-9.]+)M")
TIME_RE = re.compile(r"Time measured: ([0-9.]+) seconds")
TOTAL_RE = re.compile(r"Total rays: ([0-9]+)")

RAW_CSV = "benchmark_torch_raw.csv"
AVG_CSV = "benchmark_torch_avg.csv"
# the reference's matrix (benchmark.py:176-177), with its duplicated
# (10, 128) pair
FULL_PAIRS = [(10, 128), (20, 128), (30, 128), (40, 128), (50, 128),
              (10, 32), (10, 128), (10, 256), (10, 512)]


def run_once(scene, renderer_flag, depth, samples, width, height,
             timeout=3600, seed=0, devices=1, device="cuda",
             shared_instances=False):
    """One CLI process: (seconds, total rays, Mrays/s) from its stdout."""
    cmd = [sys.executable, "-m", "sycl_ray_tracer_torch", scene,
           renderer_flag, "-d", str(depth), "-s", str(samples),
           "--width", str(width), "--height", str(height),
           "--seed", str(seed), "-o", os.devnull]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    if shared_instances:
        cmd.append("--shared-instances")
    if devices > 1:
        cmd += ["--devices", str(devices)]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"run failed: {' '.join(cmd)}\n"
                           f"{out.stderr[-2000:]}")
    text = out.stdout
    return (float(TIME_RE.search(text).group(1)),
            int(TOTAL_RE.search(text).group(1)),
            float(RAYS_RE.search(text).group(1)))


def run_once_inproc(ctx, scene, renderer, depth, samples, width, height,
                    seed=0, device="cuda", shared_instances=False):
    """One frame in this process, timed by utils/cli.py:timed_frame:
    (seconds, total rays, Mrays/s). ctx caches each loaded scene."""
    import torch

    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.models.renderer import get_renderer
    from sycl_ray_tracer_torch.utils.cli import (load_scene,
                                                 resolve_scene_bytes,
                                                 timed_frame)

    dev = torch.device(device)
    key = (scene, shared_instances)
    if key not in ctx:
        ctx[key] = load_scene(resolve_scene_bytes(scene), dev,
                              shared_instances, log=lambda *a: None)
    built, host = ctx[key]
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device=dev)
    render = get_renderer(renderer)
    (_, rays), secs = timed_frame(
        lambda: render(built, cam, width=width, height=height, spp=samples,
                       max_depth=depth, seed=seed), dev)
    total = int(rays.sum())
    return secs, total, total / secs / 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", nargs="*",
                    default=["sponza_proc", "minecraft_proc"])
    ap.add_argument("--depths", nargs="*", type=int, default=[10])
    ap.add_argument("--samples", nargs="*", type=int, default=[4])
    ap.add_argument("--runs", type=int, default=3,
                    help="timed runs per config (plus 1 discarded warm-up)")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--resolutions", nargs="*", default=None,
                    help="WxH list overriding --width/--height")
    ap.add_argument("--pairs", nargs="*", default=None,
                    help="explicit depth:samples pairs (e.g. 30:128 "
                         "10:512), overriding --depths/--samples and --full")
    ap.add_argument("--full", action="store_true",
                    help="the reference's 9 (depth, spp) pairs")
    ap.add_argument("--renderers", nargs="*",
                    default=["megakernel", "wavefront"])
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-run subprocess timeout (s)")
    ap.add_argument("--inproc", action="store_true",
                    help="render in this process instead of one CLI "
                         "subprocess per run")
    ap.add_argument("--devices", type=int, default=1,
                    help="render every run over this many devices "
                         "(the CLI's --devices; subprocess mode only)")
    ap.add_argument("--append", action="store_true",
                    help="keep existing CSV rows; new rows replace only "
                         "matching (renderer, scene, res, depth, samples) "
                         "configs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shared-instances", action="store_true",
                    help="two-level instancing (the CLI's flag)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: CUDA is not available; pass --device cpu "
                         "to run on the CPU")
    if args.inproc and args.devices > 1:
        raise SystemExit("error: --devices with --inproc is not supported; "
                         "leave out --inproc to run each frame through "
                         "the CLI's --devices")
    ctx = {}
    if not args.inproc:
        print("WARNING: subprocess mode times each run's frame as the "
              "first of a fresh process (kernel library load, allocator "
              "growth); use --inproc for steady numbers", flush=True)

    if args.pairs:
        pairs = [tuple(int(x) for x in p.split(":")) for p in args.pairs]
    elif args.full:
        pairs = FULL_PAIRS
    else:
        pairs = [(d, s) for d in args.depths for s in args.samples]
    # the reference's matrix lists 10:128 on both sweep axes: measure
    # each config once
    pairs = list(dict.fromkeys(pairs))
    resolutions = [tuple(int(x) for x in r.split("x"))
                   for r in args.resolutions] if args.resolutions \
        else [(args.width, args.height)]

    raw_rows = []
    avg_rows = []
    old_raw, old_avg = ([], [])
    if args.append:
        old_raw, old_avg = _read_csvs()
    # wavefront groups run first, as in benchmark.py
    for renderer, flag in (("wavefront", "-w"), ("megakernel", "-m")):
        if renderer not in args.renderers:
            continue
        for scene in args.scenes:
            label = scene + ("+shared" if args.shared_instances else "")
            for width, height in resolutions:
                res = f"{width}x{height}"
                for d, s in pairs:
                    per_run = []
                    # committed to raw_rows only if a measured run lands
                    # (benchmark.py keeps the CSVs consistent this way)
                    cfg_raw = []
                    try:
                        for r in range(args.runs + 1):
                            if args.inproc:
                                t, total, mrays = run_once_inproc(
                                    ctx, scene, renderer, d, s, width,
                                    height, seed=r, device=args.device,
                                    shared_instances=args.shared_instances)
                            else:
                                t, total, mrays = run_once(
                                    scene, flag, d, s, width, height,
                                    timeout=args.timeout, seed=r,
                                    devices=args.devices,
                                    device=args.device,
                                    shared_instances=args.shared_instances)
                            print(f"{label} {renderer} {res} d={d} s={s} "
                                  f"run={r}: {mrays:.2f} Mrays/s"
                                  + (" (warm-up, discarded)"
                                     if r == 0 else ""), flush=True)
                            cfg_raw.append([renderer, label, res, d, s, r, t,
                                            mrays, total])
                            if r > 0:
                                per_run.append((t, mrays, total))
                    except (RuntimeError,
                            subprocess.TimeoutExpired) as e:
                        # keep sweeping; a failed config gets a nan row
                        print(f"{label} {renderer} {res} d={d} s={s} "
                              f"FAILED: {str(e)[:200]}", flush=True)
                        if args.inproc and not _backend_alive(args.device):
                            # a CUDA error poisons this process's context:
                            # every further config would fail too
                            print("device unusable after failure — "
                                  "aborting sweep (finished rows are "
                                  "saved; re-run with --append to "
                                  "fill the rest)", flush=True)
                            _write_csvs(_merge(old_raw, raw_rows),
                                        _merge(old_avg, avg_rows))
                            return
                    if per_run:
                        raw_rows.extend(cfg_raw)
                        warn = _stall_warning(per_run)
                        if warn:
                            print(f"{label} {renderer} {res} d={d} s={s} "
                                  f"{warn}", flush=True)
                        avg_rows.append([
                            renderer, label, res, d, s,
                            statistics.mean(x[0] for x in per_run),
                            statistics.mean(x[1] for x in per_run),
                            statistics.mean(x[2] for x in per_run),
                        ])
                    else:
                        avg_rows.append([renderer, label, res,
                                         d, s, "nan", "nan", "nan"])
                    # rewrite the CSVs after every config
                    _write_csvs(_merge(old_raw, raw_rows),
                                _merge(old_avg, avg_rows))

    _write_csvs(_merge(old_raw, raw_rows), _merge(old_avg, avg_rows))
    print(f"wrote {RAW_CSV}, {AVG_CSV}")


def _stall_warning(per_run):
    """A warning string when a timed run's wall time is over twice
    another's (benchmark.py:_stall_warning), else None. per_run holds
    (seconds, Mrays/s, total) triples."""
    times = [x[0] for x in per_run]
    if len(times) < 2 or min(times) <= 0:
        return None
    ratio = max(times) / min(times)
    if ratio <= 2.0:
        return None
    return (f"WARNING: run time spread {ratio:.1f}x "
            f"(min {min(times):.1f}s, max {max(times):.1f}s) — "
            f"likely a device stall; re-measure this config "
            f"(--append replaces its rows)")


def _backend_alive(device) -> bool:
    """Can the device still run a trivial program? After a CUDA error
    (an illegal address, a failed launch) the process's context is
    unusable, and every later call raises."""
    import torch

    try:
        return float(torch.arange(4.0, device=device).sum()) == 6.0
    except RuntimeError:
        return False


def _merge(old_rows, new_rows):
    """Old rows first, minus any whose (renderer, scene, res, depth,
    samples) config was re-measured in this sweep; a failed config's
    nan row never evicts measured data (benchmark.py:_merge)."""
    def k(r):
        return tuple(str(x) for x in r[:5])

    def is_nan(r):
        return str(r[5]) == "nan"

    if not old_rows:
        return new_rows
    old_keys = {k(r) for r in old_rows}
    new_rows = [r for r in new_rows
                if not (is_nan(r) and k(r) in old_keys)]
    redone = {k(r) for r in new_rows}
    kept = [r for r in old_rows if k(r) not in redone]
    return kept + new_rows


def _read_csvs():
    """Existing CSV rows (raw, avg). As benchmark.py:_read_csvs, a row
    one column short (the reference's layout before the res column)
    reads back with res 512x512."""
    out = []
    for path, ncols in ((RAW_CSV, 9), (AVG_CSV, 8)):
        rows = []
        try:
            with open(path, newline="") as f:
                for i, row in enumerate(csv.reader(f)):
                    if i == 0 or not row:
                        continue
                    if len(row) == ncols - 1:
                        row = row[:2] + ["512x512"] + row[2:]
                    rows.append(row)
        except FileNotFoundError:
            pass
        out.append(rows)
    return out[0], out[1]


def _write_csvs(raw_rows, avg_rows):
    with open(RAW_CSV, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["renderer", "scene", "res", "depth", "samples",
                    "run", "time_s", "mrays_per_sec", "total_rays"])
        w.writerows(raw_rows)
    with open(AVG_CSV, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["renderer", "scene", "res", "depth", "samples",
                    "time_s", "mrays_per_sec", "total_rays"])
        w.writerows(avg_rows)


if __name__ == "__main__":
    main()
