"""Command line with the reference's flags and stdout contract.

Parity target: main.cpp:8-77 plus the three benchmark-scraped lines
(render_wavefront.cpp:425-427):

    Time measured: {:.6f} seconds
    Total rays: {}
    Rays/sec: {:.2f}M

Flags match main.cpp:11-28 (-d/--max-depth default 10, -s/--sample-count
default 32, positional scene path defaulting to ./assets/sponza.glb; a
missing file is an error). --width/--height lift the reference's
hardcoded 1920x1080 (main.cpp:36). Additions: --seed, --output, --rr,
--warmup, --device, and procedural scene names (sponza_proc /
minecraft_proc / triangle / cube / dielectric) for when no .glb is at
hand.

Only the wavefront engine is ported; -m raises. The default device is
cuda, and a machine without CUDA is an error: the CPU runs only when
asked for with --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

DEFAULT_SCENE = "./assets/sponza.glb"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sycl_ray_tracer_torch",
        description="Monte-Carlo path tracer (PyTorch + CUDA)")
    p.add_argument("scene_path", nargs="?", default=DEFAULT_SCENE,
                   help="path to .glb, or a procedural name: sponza_proc, "
                        "minecraft_proc, triangle, cube, dielectric")
    p.add_argument("-d", "--max-depth", type=int, default=10)
    p.add_argument("-s", "--sample-count", type=int, default=32)
    p.add_argument("-m", "--megakernel", action="store_true",
                   help="use megakernel renderer (not yet ported)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rr", action="store_true",
                   help="russian-roulette path termination (unbiased; "
                        "extension over the reference)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--warmup", action="store_true",
                   help="run one untimed frame first (kernel build, "
                        "allocator warm-up)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def resolve_scene_bytes(scene_path: str) -> bytes:
    from sycl_ray_tracer_torch.utils import fixtures, procgen

    named = {
        "triangle": fixtures.triangle_scene_glb,
        "cube": fixtures.cube_scene_glb,
        "dielectric": fixtures.dielectric_scene_glb,
        "sponza_proc": procgen.sponza_like_glb,
        "minecraft_proc": procgen.minecraft_like_glb,
    }
    if scene_path in named:
        return named[scene_path]()
    if not os.path.exists(scene_path):
        raise SystemExit(
            f"error: scene not found: {scene_path} "
            f"(procedural names: {', '.join(sorted(named))})")
    with open(scene_path, "rb") as f:
        return f.read()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.megakernel:
        raise NotImplementedError("megakernel not yet ported")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "render on the CPU")
    device = torch.device(args.device)

    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.models.scene import build_device_scene
    from sycl_ray_tracer_torch.models.wavefront import render_wavefront
    from sycl_ray_tracer_torch.utils.gltf import load_glb
    from sycl_ray_tracer_torch.utils.image_io import write_png

    print(f"Loading scene: {args.scene_path}")
    host = load_glb(resolve_scene_bytes(args.scene_path))
    print(f"Triangles: {host.num_triangles}")
    scene = build_device_scene(host, device=device)
    cam = make_camera(args.width, args.height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device=device)

    def run(seed):
        return render_wavefront(scene, cam, width=args.width,
                                height=args.height, spp=args.sample_count,
                                max_depth=args.max_depth, seed=seed,
                                rr=args.rr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.warmup:
        run(args.seed + 1)
        sync()

    sync()
    begin = time.perf_counter()
    img, rays = run(args.seed)
    sync()
    secs = time.perf_counter() - begin
    total_rays = int(rays.sum())
    print(f"Time measured: {secs:.6f} seconds")
    print(f"Total rays: {total_rays}")
    print(f"Rays/sec: {total_rays / secs / 1e6:.2f}M")

    print("Writing image to disk")
    write_png(args.output, img.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
