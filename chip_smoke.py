"""Drive the PyTorch port's main path once on one CUDA card, check every
kernel on that path against its plain PyTorch version, and report.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles the CUDA kernels from csrc/ with nvcc (timed);
3. kernel against plain on the procedural Sponza (scale 2, 248K
   triangles): 65,536 primary and 65,536 first-bounce rays; tri ids
   equal outside 1e-6-relative t ties, t rtol 1e-4, u/v atol 1e-4;
   t_init = t gives no hit; inactive lanes report t = 0, tri = -1;
4. the same comparison, then the times of kernel and plain, at 1M
   primary and 1M bounce rays;
5. the cube fixture rendered on cuda and on the cpu through the same
   port, compared with the flip-tolerant image gate;
6. the headline render: sponza_proc scale 2, 1024x1024, 64 spp,
   depth 10, after an untimed 1-spp warm-up with another seed; checks
   that every bounce launched the kernel once and that the image is
   finite and not black.

The last two lines of standard output are a JSON object with one entry
per kernel, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = "sycl_ray_tracer_tpu/ops/traverse_pallas8.py:371"
SOURCE = "sycl_ray_tracer_torch/csrc/traverse8.cu"
# flip-tolerant image gate (the thresholds of tests/test_render.py)
RMSE_GATE = 2e-3
FLIP_THRESH = 0.05
FLIP_FRACTION_MAX = 5e-3
RMSE_UNTRIMMED_GATE = 4e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is "
                           "available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return smi


def phase_build():
    from sycl_ray_tracer_torch.ops import traverse8 as t8

    t0 = time.perf_counter()
    path = t8.build_library()
    secs = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(path)} in {secs:.2f} s")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "error" in line:
                log("[build]   " + line.strip())
    t8._load()


def _rays_from_queue(q: torch.Tensor, n: int):
    from sycl_ray_tracer_torch.ops.vec import V3

    q = q[:, :n].contiguous()
    return V3(q[0], q[1], q[2]), V3(q[3], q[4], q[5])


def make_rays(scene, cam, width: int, height: int, n: int):
    """n primary rays (one sample per pixel of a width x height frame)
    and n first-bounce rays: the survivors of one port bounce over two
    samples per pixel, in the queue's coherence order."""
    from sycl_ray_tracer_torch.models import wavefront as wf

    q, _ = wf._gen_queue(cam, 7, 0, width=width, height=height, waves=1)
    primary = _rays_from_queue(q, n)
    q, q_id = wf._gen_queue(cam, 7, 0, width=width, height=height, waves=2)
    acc = torch.zeros((width * height, 3), device=q.device)
    q, _ = wf._bounce(scene, q, q_id, 0, acc, 7, 0)
    if q.shape[1] < n:
        raise RuntimeError(f"only {q.shape[1]} bounce rays survived")
    return primary, _rays_from_queue(q, n)


def compare_hits(scene, o, d, label: str) -> float:
    """Kernel against plain on the same rays; returns max |t| error."""
    from sycl_ray_tracer_torch.ops.traverse8 import traverse8, traverse8_plain

    args = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni, o, d)
    k = traverse8(*args)
    p = traverse8_plain(*args)
    torch.cuda.synchronize()
    kt, pt = k.t.cpu().numpy(), p.t.cpu().numpy()
    ki, pi = k.tri.cpu().numpy(), p.tri.cpu().numpy()
    if not ((ki >= 0) == (pi >= 0)).all():
        raise AssertionError(f"{label}: hit/miss differ on "
                             f"{int(((ki >= 0) != (pi >= 0)).sum())} rays")
    hit = pi >= 0
    tie = np.abs(kt - pt) <= 1e-6 * np.abs(pt)
    bad = hit & (ki != pi) & ~tie
    if bad.any():
        raise AssertionError(f"{label}: tri ids differ outside ties on "
                             f"{int(bad.sum())} rays")
    same = hit & (ki == pi)
    np.testing.assert_allclose(kt[hit], pt[hit], rtol=1e-4)
    for a, b in ((k.u, p.u), (k.v, p.v)):
        np.testing.assert_allclose(a.cpu().numpy()[same],
                                   b.cpu().numpy()[same], atol=1e-4)
    if not (ki[~hit] == -1).all() or not (kt[~hit] == pt[~hit]).all():
        raise AssertionError(f"{label}: miss lanes differ")

    # t_init chaining: nothing is strictly closer than the found t
    k2 = traverse8(*args, t_init=k.t)
    if not bool((k2.tri == -1).all()):
        raise AssertionError(f"{label}: t_init = t still reports hits")
    # inactive lanes: t = 0, tri = -1, u = v = 0; active lanes unchanged
    gen = torch.Generator(device="cpu").manual_seed(11)
    active = (torch.rand(o.x.shape[0], generator=gen) < 0.5).to(o.x.device)
    k3 = traverse8(*args, active=active)
    ina = ~active
    if not (bool((k3.tri[ina] == -1).all()) and bool((k3.t[ina] == 0).all())
            and bool((k3.u[ina] == 0).all())
            and bool((k3.v[ina] == 0).all())):
        raise AssertionError(f"{label}: inactive lanes not (0, -1, 0, 0)")
    if not (bool((k3.tri[active] == k.tri[active]).all())
            and bool((k3.t[active] == k.t[active]).all())):
        raise AssertionError(f"{label}: active lanes changed with a mask")
    err = float(np.abs(kt[same] - pt[same]).max()) if same.any() else 0.0
    log(f"[kernel] {label}: {o.x.shape[0]} rays, {hit.mean():.4f} hit, "
        f"{int((hit & (ki != pi)).sum())} tie-broken ids, "
        f"max |dt| {err:.3g}: ok")
    return err


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(scene, rays, smi: str):
    from sycl_ray_tracer_torch.ops.traverse8 import traverse8, traverse8_plain

    out = {}
    for label, (o, d) in rays.items():
        args = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
                scene.sah_ni, o, d)
        plain_a = time_ms(lambda: traverse8_plain(*args), 2)
        kern_a = time_ms(lambda: traverse8(*args), 10)
        kern_b = time_ms(lambda: traverse8(*args), 10)
        plain_b = time_ms(lambda: traverse8_plain(*args), 2)
        kern, plain = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
        n = o.x.shape[0]
        log(f"[times] {label} {n} rays on {smi}: kernel {kern:.3f} ms "
            f"({n / kern / 1e3:.1f} Mrays/s; runs {kern_a:.3f}, "
            f"{kern_b:.3f}), plain {plain:.3f} ms (runs {plain_a:.3f}, "
            f"{plain_b:.3f})")
        out[label] = (kern, plain)
    return out


def check_images(a: np.ndarray, b: np.ndarray, label: str) -> None:
    d = np.abs(a - b).max(axis=-1)
    flips = d > FLIP_THRESH
    trimmed = float(np.sqrt(np.mean(
        (a[~flips].astype(np.float64) - b[~flips]) ** 2)))
    untrimmed = float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))
    log(f"[cross] {label}: flips {flips.mean():.5f}, trimmed RMSE "
        f"{trimmed:.3g}, untrimmed {untrimmed:.3g}")
    if not (flips.mean() < FLIP_FRACTION_MAX and trimmed < RMSE_GATE
            and untrimmed < RMSE_UNTRIMMED_GATE):
        raise AssertionError(f"{label}: images disagree")


def load(glb: bytes, width: int, height: int, device):
    from sycl_ray_tracer_torch.models.scene import build_device_scene
    from sycl_ray_tracer_torch.utils.gltf import load_glb

    host = load_glb(glb)
    scene = build_device_scene(host, device=device)
    return scene, camera(host, width, height, device), host


def camera(host, width: int, height: int, device):
    from sycl_ray_tracer_torch.models.camera import make_camera

    return make_camera(width, height, host.camera_position,
                       host.camera_direction, host.camera_focal_length,
                       device=device)


def phase_cross_check():
    from sycl_ray_tracer_torch.models.wavefront import render_wavefront
    from sycl_ray_tracer_torch.utils.fixtures import cube_scene_glb

    kw = dict(width=96, height=96, spp=4, max_depth=8, seed=0)
    imgs, tallies = [], []
    for dev in ("cuda", "cpu"):
        scene, cam, _ = load(cube_scene_glb(), 96, 96, torch.device(dev))
        img, rays = render_wavefront(scene, cam, **kw)
        imgs.append(img.cpu().numpy())
        tallies.append(rays.numpy())
    log(f"[cross] cube 96x96 spp4 d8 tallies cuda {tallies[0].tolist()} "
        f"cpu {tallies[1].tolist()}")
    check_images(imgs[0], imgs[1], "cube cuda vs cpu")
    slack = np.maximum(16, 0.005 * tallies[1])
    if (np.abs(tallies[0] - tallies[1]) > slack).any():
        raise AssertionError("cube: per-bounce tallies differ beyond the "
                             "flip tail")


def phase_headline(scene, cam, smi: str):
    from sycl_ray_tracer_torch.models.wavefront import render_wavefront
    from sycl_ray_tracer_torch.ops.traverse8 import traverse8

    kw = dict(width=1024, height=1024, max_depth=10)
    render_wavefront(scene, cam, spp=1, seed=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    traverse8.launches = 0
    t0 = time.perf_counter()
    img, rays = render_wavefront(scene, cam, spp=64, seed=0, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = traverse8.launches
    total = int(rays.sum())
    print(f"Time measured: {secs:.6f} seconds")
    print(f"Total rays: {total}")
    print(f"Rays/sec: {total / secs / 1e6:.2f}M")
    bounces = int((rays > 0).sum())
    log(f"[headline] sponza_proc scale 2 1024x1024 spp64 d10 on {smi}: "
        f"{total / secs / 1e6:.4f} Mrays/s, tallies {rays.tolist()}, "
        f"kernel launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != bounces:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{bounces} bounces")
    img = img.cpu().numpy()
    if not np.isfinite(img).all() or img.max() <= 0.0 or img.mean() < 0.01:
        raise AssertionError("headline image is not finite or is black")
    if total != int(rays.sum()) or rays[0] != 1024 * 1024 * 64:
        raise AssertionError("ray tallies inconsistent")
    log(f"[headline] image mean {img.mean():.4f}, max {img.max():.4f}")
    return launches


def main() -> int:
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb

    t0 = time.perf_counter()
    scene, cam, host = load(sponza_like_glb(scale=2), 1024, 1024,
                            torch.device("cuda"))
    log(f"[scene] sponza_proc scale 2: {scene.num_triangles} triangles, "
        f"NI {scene.sah_ni}, depth {scene.bvh_depth}, built in "
        f"{time.perf_counter() - t0:.2f} s")

    prim, bounce = make_rays(scene, camera(host, 256, 256, cam.center.device),
                             256, 256, 65536)
    err = max(compare_hits(scene, *prim, "primary"),
              compare_hits(scene, *bounce, "bounce"))

    prim1m, bounce1m = make_rays(scene, cam, 1024, 1024, 1 << 20)
    err = max(err, compare_hits(scene, *prim1m, "primary 1M"),
              compare_hits(scene, *bounce1m, "bounce 1M"))
    times = phase_times(scene, {"primary": prim1m, "bounce": bounce1m},
                        smi)
    del prim1m, bounce1m

    phase_cross_check()
    launches = phase_headline(scene, cam, smi)

    kern_ms, plain_ms = times["bounce"]
    print(json.dumps({"kernels": [{
        "name": "traverse8", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
