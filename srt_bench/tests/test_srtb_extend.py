"""A new configuration, traffic mix and per-layer metric join the
benchmark as new files and entries alone, found by name."""

import json
import os
import time

from srt_bench import cells, run


def test_new_files_add_a_cell_and_a_metric(small):
    bench_path, data = small
    with open(os.path.join(data, "configs", "sponza_proc.json")) as f:
        config = json.load(f)
    config["generator"] = {"module": "srt_bench.scenes.procgen",
                           "function": "minecraft_like_glb",
                           "args": {"n": 24, "seed": 5}}
    config["form"] = "baked"
    with open(os.path.join(data, "configs", "voxels_baked.json"), "w") as f:
        json.dump(config, f)
    traffic = {"engine": "megakernel", "cards": 1, "width": 24,
               "height": 16, "spp": 2, "max_depth": 3}
    with open(os.path.join(data, "traffic", "tiny_mk.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(data, "limits", "voxels_baked.tiny_mk.json"),
              "w") as f:
        json.dump({"grid": [24, 16], "limits": {"pixel_q90": 0.05,
                                              "tally_gap": 0.05}}, f)
    with open(os.path.join(data, "metrics", "frames_seen.py"), "w") as f:
        f.write("def read(w):\n    return float(w.frames)\n")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "voxels_baked", "source": "test",
                             "file": "voxels_baked.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "voxels_baked.tiny_mk",
                               "config": "voxels_baked",
                               "traffic": "tiny_mk", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frame_s",
                               "workloads": ["voxels_baked.tiny_mk"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    cell = cells.load("voxels_baked.tiny_mk", bench_path, data)
    assert cell.traffic["engine"] == "megakernel"
    assert [m["name"] for m in cell.per_layer][-1] == "frames_seen"
    r = run.run_rank(0, "cpu", cell, 3, 0.1, True, time.time())
    assert r["correct"], r["checks"]
    assert r["metrics"]["frames_seen"]["value"] == r["attempted"]
    # a metric with no `workloads` key is reported in every cell
    del bench["per_layer"][-1]["workloads"]
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    assert "frames_seen" in [m["name"] for m in cells.load(
        "sponza_proc.wavefront", bench_path, data).per_layer]
