"""A copy of the benchmark's data at a size the CPU renders in seconds:
the same cells, configurations and limits, with the scenes at sponza
scale 1 with images of 256 x 256 and n = 72 and the frames at 48 x 32,
8 spp, depth 4."""

import json
import os
import shutil

import pytest

from srt_bench import cells

SMALL_SCENES = {"sponza_proc": {"scale": 1, "texture_res": 256},
                "minecraft_proc": {"n": 72}}
SMALL_FRAME = {"width": 48, "height": 32, "spp": 8, "max_depth": 4}


def small_copy(dest: str) -> str:
    """The benchmark's data under dest, cut to the CPU's size; returns
    the path of its BENCHMARK.json."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(cells.HERE, sub),
                        os.path.join(dest, sub))
    for name, args in SMALL_SCENES.items():
        path = os.path.join(dest, "configs", name + ".json")
        with open(path) as f:
            c = json.load(f)
        c["generator"]["args"].update(args)
        with open(path, "w") as f:
            json.dump(c, f)
    for name in os.listdir(os.path.join(dest, "traffic")):
        path = os.path.join(dest, "traffic", name)
        with open(path) as f:
            t = json.load(f)
        t.update(SMALL_FRAME)
        with open(path, "w") as f:
            json.dump(t, f)
    bench = os.path.join(dest, "BENCHMARK.json")
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), bench)
    return bench


@pytest.fixture
def small(tmp_path):
    """(BENCHMARK.json path, data dir) of a small copy."""
    return small_copy(str(tmp_path)), str(tmp_path)
