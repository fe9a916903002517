"""The control of the check: the plain reference put in the program's
place, with its path state (origin, direction, attenuation, radiance)
rounded to bfloat16 after every bounce, the step below the float32
that the configurations state. A sound check refuses it.

    python3 -m srt_bench.control --workload <cell> --seeds 11 12 13

renders, for each seed, the pixels that a run of that seed would check
(frame 0 of the window), once in float32 and once in the lower
precision, and prints one JSON line per seed with the numbers that
check.py compares, the control in the program's place. The benchmark's
own runs never run it. It runs on the first CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from srt_bench import cells, check
from srt_bench.reference import ingest
from srt_bench.reference.render import DeviceRef, camera, render_pixels

LOWER = torch.bfloat16


def readings(cell, seed: int, device, ref=None) -> dict:
    """The control's numbers for one seed, with the cell's limits."""
    tr = cell.traffic
    width, height, spp, depth = (tr["width"], tr["height"], tr["spp"],
                                 tr["max_depth"])
    rs = ref.s if ref is not None else ingest.load(
        cells.scene_bytes(cell.config))
    ref = ref or DeviceRef(rs, device)
    px, py = check.sample_pixels(seed % (1 << 63), width, height,
                                 cell.check["grid"])
    cam = camera(rs, width, height, device)
    args = (ref, cam, torch.as_tensor(px, device=device),
            torch.as_tensor(py, device=device))
    kw = dict(width=width, spp=spp, max_depth=depth, seed=seed * 1000)
    img, tallies = render_pixels(*args, **kw)
    low, low_tallies = render_pixels(*args, state_dtype=LOWER, **kw)
    paths = px.shape[0] * spp
    return check.compare(low.cpu().numpy(), img.cpu().numpy(),
                         low_tallies.numpy(), tallies.numpy(), paths, paths,
                         cell.check["limits"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m srt_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    rs = ingest.load(cells.scene_bytes(cell.config))
    ref = DeviceRef(rs, device)
    for seed in args.seeds:
        checks = readings(cell, seed, device, ref)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": str(LOWER), "checks": checks,
                          "refused": not check.passed(checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
