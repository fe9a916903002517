"""The benchmark's data, found by name: a cell of BENCHMARK.json, its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the limits of its check
(limits/<cell>.json) and the readers of its per-layer metrics
(metrics/<metric>.py). A later cell, mix, configuration or metric is a
new file here and an entry in BENCHMARK.json; no code changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict         # configs/<config>.json, with "name"
    traffic: dict        # traffic/<traffic>.json, with "name"
    check: dict          # limits/<cell>.json
    end_to_end: list     # BENCHMARK.json entries that this cell reports
    per_layer: list
    data_dir: str = HERE


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, bench_path: str | None = None,
         data_dir: str | None = None) -> Cell:
    """The cell called `cell` in BENCHMARK.json (at the checkout's root
    unless bench_path is given), with its files from data_dir (this
    folder unless given)."""
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    data_dir = data_dir or HERE
    spec = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if spec is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; it has "
                       f"{sorted(w['name'] for w in bench['workloads'])}")
    config = dict(_json(os.path.join(data_dir, "configs",
                                     spec["config"] + ".json")),
                  name=spec["config"])
    traffic = dict(_json(os.path.join(data_dir, "traffic",
                                      spec["traffic"] + ".json")),
                   name=spec["traffic"])
    if traffic["cards"] != spec["chips"]:
        raise ValueError(f"{cell}: BENCHMARK.json asks for {spec['chips']} "
                         f"chips, traffic {spec['traffic']} for "
                         f"{traffic['cards']} cards")
    check = _json(os.path.join(data_dir, "limits", cell + ".json"))
    return Cell(name=cell, chips=spec["chips"], config=config,
                traffic=traffic, check=check,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, cell)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, cell)],
                data_dir=data_dir)


def scene_bytes(config: dict) -> bytes:
    """The GLB bytes of a configuration: its generator (a function of a
    module under srt_bench/scenes/) called with its arguments."""
    module = importlib.import_module(config["generator"]["module"])
    return getattr(module, config["generator"]["function"])(
        **config["generator"]["args"])


def reader(metric: str, data_dir: str | None = None):
    """The read(window) function of metrics/<metric>.py."""
    path = os.path.join(data_dir or HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        f"srt_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
