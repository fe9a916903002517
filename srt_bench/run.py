"""The port's benchmark: one run of one cell.

    python3 -m srt_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json) names a scene
configuration (configs/), a traffic mix (traffic/) and its cards. One
process, or on several cards one process per card (the port's
parallel/mesh.py:spawn over NCCL, rank 0 reporting), does in order:

1. generate the scene's GLB bytes with the benchmark's frozen generator
   (scenes/procgen.py), from the configuration's own generator seed;
2. load and build through the port's utils/cli.py:load_scene, timed to
   a synchronize (build_s) and the device memory it leaves allocated
   (tables_mib);
3. make the camera (models/camera.py:make_camera) and warm up with one
   frame of the cell's shape;
4. render whole frames back to back, frame i with seed seed * 1000 + i,
   each from a synchronize to a synchronize, until --seconds have
   passed: the window runs from its first synchronize to the one that
   ends the last frame begun inside it. With --trace 1 a torch.profiler
   trace (CPU and CUDA activity) covers the window;
5. hold one frame of the window against the plain reference
   (check.py), once the window has closed, the peak memory has been
   read and the program's state is freed;
6. print, as the last line of standard output, one JSON object: correct,
   attempted and failed (frames), metrics (the cell's end-to-end metrics
   with --trace 0, its per-layer ones with --trace 1), device, with
   --trace 1 a breakdown, and last the numbers compared with their
   limits, which also end standard error.

A run without enough CUDA devices, or one whose process holds jax,
jaxlib, flax or sycl_ray_tracer_tpu once the window has closed, exits
with a code other than 0 and prints no result. Kernel and extension
caches go to fixed directories under the checkout's build/.
"""

import time

T0 = time.time()  # the set-up clock starts as the process does

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from srt_bench import arith, cells, check  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sycl_ray_tracer_tpu")
WARMUP_FRAME = 999  # frame seeds seed * 1000 + i; the window never gets here


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _set_cache_dirs() -> None:
    """Fixed cache directories inside the checkout for whatever the
    program builds through torch's extension loader or Triton (its own
    CUDA library already lives in build/kernels/)."""
    cache = os.path.join(cells.ROOT, "build", "srt_bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules() -> list:
    """Top-level names of the loaded modules that the benchmark may not
    load, each compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _engine(traffic: dict, world: int):
    if world > 1:
        import functools

        from sycl_ray_tracer_torch.parallel.mesh import make_mesh, render_sharded

        mesh = make_mesh(traffic.get("dp"), traffic.get("sp", 1))
        return functools.partial(render_sharded, mesh=mesh,
                                 renderer=traffic["engine"])
    from sycl_ray_tracer_torch.models.renderer import get_renderer

    return get_renderer(traffic["engine"])


def _trace_window(prof, frames, window_s, rays, card):
    """The traced window as arith.Window, from the profiler's raw
    events (kineto's, in ns; torch's own parse of them into
    FunctionEvents takes minutes on a window of a million operations)."""
    from torch.autograd import DeviceType

    w = arith.Window(frames=frames, window_s=window_s, rays=rays, card=card)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        span = (name, e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                w.ranges.append(span)
            else:
                w.device_ops.append(span)
        elif name == "srtb.window":
            w.t0_us, w.t1_us = span[1], span[2]
        elif name.startswith(("srt.", "srtb.")):
            w.host_ranges.append(span)
    return w


def run_rank(rank: int, device, cell, seed: int, seconds: float,
             trace: bool, t0: float, out_path: str | None = None,
             render_wrap=None):
    """One rank's run; returns rank 0's result (and writes it to
    out_path as JSON when given), None on the other ranks. render_wrap,
    for the tests, wraps the engine's render function."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.utils.cli import load_scene

    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    cuda = device.type == "cuda"
    tr = cell.traffic
    width, height, spp, depth = (tr["width"], tr["height"], tr["spp"],
                                 tr["max_depth"])
    log = _log if rank == 0 else (lambda *a: None)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    glb = cells.scene_bytes(cell.config)
    mem0 = torch.cuda.memory_allocated(device) if cuda else 0
    sync()
    begin = time.perf_counter()
    scene, host = load_scene(glb, device, cell.config["form"] == "two_level",
                             log=log)
    sync()
    build_s = time.perf_counter() - begin
    tables = (torch.cuda.memory_allocated(device) if cuda else 0) - mem0
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device=device)
    render = _engine(tr, world)
    if render_wrap is not None:
        render = render_wrap(render)

    def frame(i):
        return render(scene, cam, width=width, height=height, spp=spp,
                      max_depth=depth, seed=seed * 1000 + i)

    begin = time.perf_counter()
    frame(WARMUP_FRAME)
    sync()
    log(f"[srt_bench] build {build_s:.3f} s, tables {tables} B, warm-up "
        f"frame {time.perf_counter() - begin:.3f} s")

    pick = random.Random(seed)
    kept = None  # (frame index, image, tallies): one frame drawn uniformly
    secs, rays_total = [], 0
    go = torch.ones(1, dtype=torch.int32, device=device)
    with contextlib.ExitStack() as stack:
        prof = None
        if trace:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
        sync()
        t_start = time.perf_counter()
        wall_start = time.time()
        t_end = t_start
        with record_function("srtb.window"):
            while True:
                more = not secs or t_end - t_start < seconds
                if world > 1:  # rank 0's clock decides for every rank
                    go.fill_(int(more))
                    dist.broadcast(go, 0)
                    more = bool(go.item())
                if not more:
                    break
                i = len(secs)
                begin = time.perf_counter()
                with record_function("srtb.frame"):
                    img, rays = frame(i)
                sync()
                t_end = time.perf_counter()
                secs.append(t_end - begin)
                rays_total += int(rays.sum())
                if pick.randrange(i + 1) == 0:
                    kept = (i, img, rays.numpy().copy())
                del img
    window_s = t_end - t_start
    frames = len(secs)
    log("[srt_bench] frame seconds: " + " ".join(f"{s:.4f}" for s in secs))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if world > 1:
        t = torch.tensor([peak], dtype=torch.int64, device=device)
        dist.all_reduce(t, dist.ReduceOp.MAX)
        peak = int(t.item())

    win = None
    if trace:
        card = torch.cuda.get_device_name(device) if cuda else "cpu"
        win = _trace_window(prof, frames, window_s, rays_total, card)
        win.build_s, win.tables_bytes = build_s, tables
        busy = torch.tensor([arith.busy_us(win) / 1e6], dtype=torch.float64,
                            device=device)
        if world > 1:
            dist.all_reduce(busy)
        busy_s = float(busy.item()) / world

    index, img, frame_tallies = kept
    px, py = check.sample_pixels(seed % (1 << 63), width, height,
                                 cell.check["grid"])
    ours = img[torch.as_tensor(py, device=img.device),
               torch.as_tensor(px, device=img.device)].cpu().numpy()
    del scene, cam, render, frame, img, kept, prof
    if cuda:
        torch.cuda.empty_cache()
    if world > 1:
        dist.barrier()
    if rank != 0:
        return None

    from srt_bench.reference import ingest
    from srt_bench.reference.render import DeviceRef, camera, render_pixels

    begin = time.perf_counter()
    rs = ingest.load(glb)
    ref = DeviceRef(rs, device)
    ref_img, ref_tallies = render_pixels(
        ref, camera(rs, width, height, device),
        torch.as_tensor(px, device=device), torch.as_tensor(py, device=device),
        width=width, spp=spp, max_depth=depth, seed=seed * 1000 + index)
    checks = check.compare(ours, ref_img.cpu().numpy(), frame_tallies,
                           ref_tallies.numpy(), width * height * spp,
                           px.shape[0] * spp, cell.check["limits"])
    log(f"[srt_bench] reference: frame {index}, {px.shape[0]} pixels, "
        f"{time.perf_counter() - begin:.3f} s")
    ok = check.passed(checks)

    result = {"correct": ok, "attempted": frames, "failed": int(not ok)}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": world, "memory_peak_bytes": peak}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"], cell.data_dir)(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=busy_s,
                           window_s=(win.t1_us - win.t0_us) / 1e6)
        result.update(metrics=metrics, device=device_info,
                      breakdown={"device_ops": arith.top_ops(win),
                                 "idle_gaps": arith.top_gaps(win)})
    else:
        values = {"frame_s": window_s / frames,
                  "mrays_per_s": rays_total / window_s / 1e6,
                  "peak_mem_gib": peak / 2 ** 30,
                  "setup_s": wall_start - t0}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        result.update(metrics=metrics, device=device_info)
    result["checks"] = checks
    result["_forbidden"] = forbidden_modules()
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(result, f)
    return result


def _rank_entry(rank, device, cell, seed, seconds, trace, t0, out_path,
                render_wrap):
    run_rank(rank, device, cell, seed, seconds, trace, t0, out_path,
             render_wrap)


def run_cell(cell, seed: int, seconds: float, trace: bool, t0: float,
             devices: list, backend: str = "nccl", render_wrap=None):
    """The cell's run on `devices` (one rank each); rank 0's result.
    render_wrap (a module-level function, for the tests) as in
    run_rank."""
    if len(devices) == 1:
        return run_rank(0, devices[0], cell, seed, seconds, trace, t0,
                        render_wrap=render_wrap)
    from sycl_ray_tracer_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        spawn(_rank_entry, len(devices), backend, devices,
              f"file://{os.path.join(tmp, 'store')}",
              args=(cell, seed, seconds, trace, t0, out, render_wrap))
        with open(out) as f:
            return json.load(f)


def emit(result: dict) -> int:
    """Print the result, its checks last on stderr and the line last on
    stdout; refuse (exit 5, no result) where a forbidden module is
    loaded in this process or was in rank 0's."""
    found = sorted(set(forbidden_modules()) | set(result.pop("_forbidden")))
    if found:
        _log(f"[srt_bench] refused: modules {found} are loaded")
        return 5
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m srt_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_cache_dirs()
    cell = cells.load(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"[srt_bench] {args.workload} needs {cell.chips} CUDA "
             f"device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                      [f"cuda:{r}" for r in range(cell.chips)])
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
