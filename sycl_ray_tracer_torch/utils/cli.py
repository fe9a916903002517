"""Command line with the reference's flags and stdout contract.

Parity target: main.cpp:8-77 plus the three benchmark-scraped lines
(render_wavefront.cpp:425-427):

    Time measured: {:.6f} seconds
    Total rays: {}
    Rays/sec: {:.2f}M

Flags match main.cpp:11-28 (-d/--max-depth default 10, -s/--sample-count
default 32, -m megakernel, -w wavefront, the default; with both, the
megakernel wins as in main.cpp:58; positional scene path defaulting to
./assets/sponza.glb; a missing file is an error). --width/--height lift the reference's
hardcoded 1920x1080 (main.cpp:36). Additions: --seed, --output, --rr,
--scale (the reference Scene's global_scale), --warmup, --device,
--devices, --shared-instances, and procedural scene names (sponza_proc
/ minecraft_proc / instanced_proc / triangle / cube / dielectric) for
when no .glb is at hand; instanced_proc has SRT_INSTANCED_R cubes
(1000 by default), as in the JAX CLI.

Measurement switch: SRT_TRACE_DIR=<dir> records a torch.profiler trace
of the timed frame and logs the device time of each stage of
utils/profile.py and the count of each wait (traced_frame).

--shared-instances loads the scene two-level, as the reference's
Embree BLAS per primitive + TLAS of instances (scene.cpp:404-439): one
copy of each unique primitive, one transform per instance
(utils/instanced.py, models/instanced.py), intersected by the traverse5
kernel. Without it every instance is baked to world space.

--devices N renders one frame over N processes, one per device
(parallel/mesh.py, dp = N): with --device cuda, rank r uses cuda:r and
NCCL, and N must not exceed the machine's CUDA devices; with --device
cpu, N processes on the CPU use gloo. Each rank loads the scene itself;
rank 0 prints the contract lines and writes the image, its time running
from a barrier before the render to the reduced image.

The default device is cuda, and a machine without CUDA is an error,
with either engine: the CPU runs only when asked for with --device cpu.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
import time

DEFAULT_SCENE = "./assets/sponza.glb"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sycl_ray_tracer_torch",
        description="Monte-Carlo path tracer (PyTorch + CUDA)")
    p.add_argument("scene_path", nargs="?", default=DEFAULT_SCENE,
                   help="path to .glb, or a procedural name: sponza_proc, "
                        "minecraft_proc, instanced_proc, triangle, cube, "
                        "dielectric")
    p.add_argument("-d", "--max-depth", type=int, default=10)
    p.add_argument("-s", "--sample-count", type=int, default=32)
    p.add_argument("-m", "--megakernel", action="store_true",
                   help="use megakernel renderer")
    p.add_argument("-w", "--wavefront", action="store_true",
                   help="use wavefront renderer (default)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rr", action="store_true",
                   help="russian-roulette path termination (unbiased; "
                        "extension over the reference)")
    p.add_argument("--scale", type=float, nargs=3, default=(1.0, 1.0, 1.0),
                   metavar=("SX", "SY", "SZ"),
                   help="global scene scale (the Scene's global_scale)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--devices", type=int, default=1,
                   help="render over this many devices, one process each "
                        "(sample sharding)")
    p.add_argument("--warmup", action="store_true",
                   help="run one untimed frame first (kernel build, "
                        "allocator warm-up)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--shared-instances", action="store_true",
                   help="two-level instancing: one copy of each unique "
                        "primitive plus per-instance transforms, instead "
                        "of baking every instance")
    return p


def resolve_scene_bytes(scene_path: str) -> bytes:
    from sycl_ray_tracer_torch.utils import fixtures, procgen

    named = {
        "triangle": fixtures.triangle_scene_glb,
        "cube": fixtures.cube_scene_glb,
        "dielectric": fixtures.dielectric_scene_glb,
        "sponza_proc": procgen.sponza_like_glb,
        "minecraft_proc": procgen.minecraft_like_glb,
        # SRT_INSTANCED_R cubes (the JAX CLI's knob), 1000 by default
        "instanced_proc": lambda: fixtures.instanced_scene_glb(
            int(os.environ.get("SRT_INSTANCED_R", "1000"))),
    }
    if scene_path in named:
        return named[scene_path]()
    if not os.path.exists(scene_path):
        raise SystemExit(
            f"error: scene not found: {scene_path} "
            f"(procedural names: {', '.join(sorted(named))})")
    with open(scene_path, "rb") as f:
        return f.read()


def load_scene(scene_bytes: bytes, device, shared_instances: bool,
               global_scale=(1.0, 1.0, 1.0), leaf_size: int = 8, log=print):
    """(DeviceScene, host) for a .glb, baked (at `leaf_size`) or
    two-level; `host` has the camera and sky fields. Logs the triangle
    counts."""
    if shared_instances:
        from sycl_ray_tracer_torch.models.instanced import (
            build_instanced_device_scene)
        from sycl_ray_tracer_torch.utils.instanced import load_glb_instanced

        host = load_glb_instanced(scene_bytes, global_scale)
        log(f"Triangles: {host.num_world_triangles} "
            f"({host.num_unique_triangles} unique x "
            f"{host.num_instances} instances)")
        scene = build_instanced_device_scene(host, device=device)
        log(f"Instanced tree: {scene.sah_ni} internal nodes, "
            f"{scene.inst_leaf_slot.shape[0]} leaves, depth "
            f"{scene.bvh_depth}")
        return scene, host

    from sycl_ray_tracer_torch.models.scene import build_device_scene
    from sycl_ray_tracer_torch.utils.gltf import load_glb

    host = load_glb(scene_bytes, global_scale)
    log(f"Triangles: {host.num_triangles}")
    return build_device_scene(host, leaf_size, device=device), host


def timed_frame(run, device):
    """(run(), seconds): the time of a frame from a barrier of the ranks
    (under --devices) and a synchronize of the device before it to a
    synchronize after it."""
    import torch
    import torch.distributed as dist

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if dist.is_initialized():
        dist.barrier()
    sync()
    begin = time.perf_counter()
    out = run()
    sync()
    secs = time.perf_counter() - begin
    return out, secs


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi reports them
    (name, power.limit), or torch's name of the device where nvidia-smi
    cannot be run; "cpu" for the CPU."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        p = None
    if p is not None and p.returncode == 0 and p.stdout.strip():
        return p.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def traced_frame(run, device, trace_dir: str, rank: int = 0, log=print):
    """timed_frame(run, device) under torch.profiler (CPU activity, and
    CUDA activity on the card): writes the Chrome trace to
    <trace_dir>/trace_rank{rank}.json and logs the 8 device activities
    (kernels, copies, sets) with the most device time, the device time
    of each srt.<stage> range, the count of each srt.sync.<wait> range
    (utils/profile.py:sync), and the device's busy share over the frame
    (the union of the device activities' intervals, overlap counted
    once, over the frame's seconds) beside the card's name and power
    limit. Returns (run(), seconds, stats) with stats {"trace": path,
    "device_ms" (the union's length), "busy" (None on the CPU),
    "kernels": [(name, ms, count)] by device time, "stages": {range:
    device ms}, "syncs": {range: count}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out, secs = timed_frame(run, device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    kernels, stages, syncs = [], {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            if e.key.startswith("srt.sync."):
                syncs[e.key] = e.count
            continue
        ms = e.self_device_time_total / 1e3
        if not getattr(e, "is_user_annotation", False):
            kernels.append((e.key, ms, e.count))
        elif not e.key.startswith("srt.sync."):
            stages[e.key] = ms
    kernels.sort(key=lambda k: -k[1])
    spans, end, device_ms = [], None, 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            spans.append((e.start_ns() / 1e6, e.end_ns() / 1e6))
    for s, e in sorted(spans):  # the union of the intervals
        if end is None or s > end:
            device_ms, end = device_ms + e - s, e
        elif e > end:
            device_ms, end = device_ms + e - end, e
    busy = device_ms / (secs * 1e3) if device.type == "cuda" else None
    log(f"[trace] {path}: {secs:.6f} s frame on {card_label(device)}")
    for name, ms, count in kernels[:8]:
        log(f"[trace] {ms:10.3f} ms in {count:6d} calls: {name[:120]}")
    if stages:
        log("[trace] device time of the stage ranges: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(stages.items())))
    log(f"[trace] {sum(syncs.values())} srt.sync ranges"
        + "".join(f", {k} {v}" for k, v in sorted(syncs.items())))
    if busy is not None:
        log(f"[trace] device busy {device_ms:.3f} ms of {secs * 1e3:.3f} ms "
            f"= {100 * busy:.2f} %")
    return out, secs, {"trace": path, "device_ms": device_ms, "busy": busy,
                       "kernels": kernels, "stages": stages, "syncs": syncs}


def render_frame(rank: int, device, args) -> int:
    """Load, render and report one frame: the whole CLI on one device,
    or one rank's part of it under --devices (parallel/mesh.py:spawn)."""
    import torch.distributed as dist

    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.utils.image_io import write_png

    sharded = dist.is_initialized()
    log = print if rank == 0 else (lambda *a: None)
    # both flags set -> megakernel (main.cpp:58 checks -m first)
    engine = "megakernel" if args.megakernel else "wavefront"
    if sharded:
        from sycl_ray_tracer_torch.parallel.mesh import render_sharded

        render = functools.partial(render_sharded, renderer=engine)
    else:
        from sycl_ray_tracer_torch.models.renderer import get_renderer

        render = get_renderer(engine)

    log(f"Loading scene: {args.scene_path}")
    scene, host = load_scene(resolve_scene_bytes(args.scene_path), device,
                             args.shared_instances, tuple(args.scale),
                             log=log)
    cam = make_camera(args.width, args.height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device=device)

    def run(seed):
        return render(scene, cam, width=args.width, height=args.height,
                      spp=args.sample_count, max_depth=args.max_depth,
                      seed=seed, rr=args.rr)

    if args.warmup:
        run(args.seed + 1)
    # SRT_TRACE_DIR=<dir>: a profiler trace of the timed frame, the
    # port's counterpart of the JAX CLI's jax.profiler trace
    trace_dir = os.environ.get("SRT_TRACE_DIR")
    if trace_dir:
        (img, rays), secs, _ = traced_frame(lambda: run(args.seed), device,
                                            trace_dir, rank, log)
    else:
        (img, rays), secs = timed_frame(lambda: run(args.seed), device)
    total_rays = int(rays.sum())
    log(f"Time measured: {secs:.6f} seconds")
    log(f"Total rays: {total_rays}")
    log(f"Rays/sec: {total_rays / secs / 1e6:.2f}M")

    if rank == 0:
        print("Writing image to disk")
        write_png(args.output, img.cpu().numpy())
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "render on the CPU")
    n = args.devices
    if n < 1:
        raise ValueError(f"--devices must be at least 1, not {n}")
    if n == 1:
        return render_frame(0, torch.device(args.device), args)
    if args.device == "cuda":
        if n > torch.cuda.device_count():
            raise RuntimeError(
                f"--devices {n} needs {n} CUDA devices; this machine has "
                f"{torch.cuda.device_count()}")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    else:
        backend, devices = "gloo", ["cpu"] * n

    from sycl_ray_tracer_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        spawn(render_frame, n, backend, devices,
              f"file://{os.path.join(tmp, 'store')}", args=(args,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
