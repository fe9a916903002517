"""Time the headline frames of one or more checkouts of the port in turns
on one CUDA card, to tell a change in the engines from the spread of
the frame time.

    python3 frame_spread.py --tree parent=build/parent --tree change=. \\
        [--order parent,change,change,parent] [--frames 3] \\
        [--configs minecraft_wavefront,sponza_wavefront]

Each entry of --order runs in a process of its own with that tree's
package first on the path: it builds the tree's kernels, loads each
config's scene, renders an untimed 1-spp frame with another seed and
then --frames headline frames (1024x1024, 64 spp, depth 10, seed 0),
each timed from a synchronize to a synchronize, as chip_smoke.py times
its headline. The parent prints the card's name and power limit, every
frame's seconds per tree and config, and their min, median and max;
the ray totals of a config must agree between the trees. Unpack a
parent commit with `git archive` into a git-ignored directory such as
build/parent first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(width=1024, height=1024, spp=64, max_depth=10, seed=0)
# config -> (procedural scene, two-level, engine)
CONFIGS = {
    "sponza_wavefront": ("sponza_proc", False, "wavefront"),
    "minecraft_wavefront": ("minecraft_proc", True, "wavefront"),
}


def child(configs: list, frames: int) -> None:
    """Runs inside the tree: one JSON line {config: {"seconds": [...],
    "rays": total, "package": path}} on the last line of stdout."""
    # the tree (the working directory) before this script's directory
    sys.path.insert(0, os.getcwd())
    import torch

    import sycl_ray_tracer_torch

    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.models.renderer import get_renderer
    from sycl_ray_tracer_torch.utils.cli import load_scene, resolve_scene_bytes

    cuda = torch.device("cuda")
    out, loaded = {}, {}
    for name in configs:
        scene_name, shared, engine = CONFIGS[name]
        if (scene_name, shared) not in loaded:
            loaded.clear()
            torch.cuda.empty_cache()
            scene, host = load_scene(resolve_scene_bytes(scene_name), cuda,
                                     shared)
            cam = make_camera(HEADLINE["width"], HEADLINE["height"],
                              host.camera_position, host.camera_direction,
                              host.camera_focal_length, device=cuda)
            loaded[(scene_name, shared)] = (scene, cam)
        scene, cam = loaded[(scene_name, shared)]
        render = get_renderer(engine)
        render(scene, cam, **dict(HEADLINE, spp=1, seed=1))
        secs, rays = [], None
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, r = render(scene, cam, **HEADLINE)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rays = int(r.sum())
        out[name] = {"seconds": secs, "rays": rays,
                     "package": sycl_ray_tracer_torch.__file__}
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout of the repo (default: "
                         "change=.)")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, one process each "
                         "(default: each tree once)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--configs", default="minecraft_wavefront,"
                                         "sponza_wavefront")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    configs = args.configs.split(",")
    unknown = [c for c in configs if c not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configs {unknown}; known: "
                         f"{', '.join(CONFIGS)}")
    if args.child:
        child(configs, args.frames)
        return 0

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("frame_spread.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = dict(t.split("=", 1) for t in (args.tree or ["change=."]))
    trees = {k: os.path.abspath(os.path.join(ROOT, v))
             for k, v in trees.items()}
    order = args.order.split(",") if args.order else list(trees)
    runs = {name: {c: [] for c in configs} for name in trees}
    rays = {c: set() for c in configs}
    for name in order:
        tree = trees[name]
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "frame_spread.py"),
             "--child", "--frames", str(args.frames), "--configs",
             ",".join(configs)],
            cwd=tree, env=dict(os.environ, PYTHONPATH=tree), text=True,
            capture_output=True, timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"{name} ({tree}) failed:\n"
                               f"{p.stderr[-4000:]}")
        res = json.loads(p.stdout.strip().splitlines()[-1])
        pkg = {r["package"] for r in res.values()}
        if pkg != {os.path.join(tree, "sycl_ray_tracer_torch",
                                "__init__.py")}:
            raise AssertionError(f"{name} imported {pkg}, not {tree}'s "
                                 "package")
        for c in configs:
            runs[name][c].append(res[c]["seconds"])
            rays[c].add(res[c]["rays"])
            print(f"[spread] {name} {c}: " + ", ".join(
                f"{s:.4f}" for s in res[c]["seconds"]) + " s "
                f"({res[c]['rays']} rays)", flush=True)
        print(f"[spread] {name} process: {time.perf_counter() - t0:.1f} s",
              flush=True)
    for c in configs:
        if len(rays[c]) != 1:
            raise AssertionError(f"{c}: ray totals differ between the "
                                 f"trees: {sorted(rays[c])}")
        for name in trees:
            every = [s for proc in runs[name][c] for s in proc]
            if every:
                print(f"[spread] {c} {name} on {smi}: {len(every)} frames in "
                      f"{len(runs[name][c])} processes, min {min(every):.4f}"
                      f" median {statistics.median(every):.4f} max "
                      f"{max(every):.4f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
