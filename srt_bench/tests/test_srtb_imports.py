"""What a run loads, and what it refuses.

- No module that a run of srt_bench.run loads has jax, jaxlib, flax or
  sycl_ray_tracer_tpu as its top-level name (the part before the first
  dot, compared whole: the port's name begins with the JAX package's).
- The reference and the frozen scenes load nothing whose top-level
  name is sycl_ray_tracer_torch.
- A run without a card, and a run in a folder that holds only
  BENCHMARK.json and srt_bench/, exit non-zero and print no result.
- A run whose process holds a forbidden module prints no result.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from srt_bench import cells, run

REFERENCE_MODULES = ["srt_bench.reference.ingest", "srt_bench.reference.bvh",
                     "srt_bench.reference.render", "srt_bench.reference.rng",
                     "srt_bench.scenes.procgen", "srt_bench.scenes.atrium",
                     "srt_bench.check",
                     "srt_bench.arith"]


def _python(code: str, cwd: str = cells.ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run at the small size, in a fresh interpreter."""
    code = f"""
import sys, time
sys.path.insert(0, {os.path.dirname(__file__)!r})
from conftest import small_copy
from srt_bench import cells, run
bench = small_copy({str(tmp_path)!r})
for name in ("sponza_proc.wavefront", "sponza_proc.megakernel"):
    cell = cells.load(name, bench, {str(tmp_path)!r})
    run.run_rank(0, "cpu", cell, 5, 0.1, True, time.time())
import srt_bench.control
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "sycl_ray_tracer_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    p = _python("import sys\n" + "".join(f"import {m}\n"
                                         for m in REFERENCE_MODULES)
                + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"sycl_ray_tracer_torch", *run.FORBIDDEN}


@pytest.mark.parametrize("folder", ["reference", "scenes"])
def test_reference_sources_import_nothing_of_the_port(folder):
    for name in os.listdir(os.path.join(cells.HERE, folder)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(cells.HERE, folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"sycl_ray_tracer_torch", "jax",
                                     "sycl_ray_tracer_tpu"}, (name, tops)


def _bench_cmd():
    import json

    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)["command"]


def test_run_without_a_card_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(_bench_cmd() + ["--workload", "sponza_proc.wavefront",
                                       "--seed", "7", "--seconds", "1",
                                       "--trace", "0"],
                       cwd=cells.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_run_in_a_folder_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "srt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run(_bench_cmd() + ["--workload", "sponza_proc.wavefront",
                                       "--seed", "7", "--seconds", "1",
                                       "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_forbidden_module_refuses_the_result(capsys):
    result = {"correct": True, "checks": {}, "_forbidden": ["jax"]}
    assert run.emit(result) != 0
    assert capsys.readouterr().out == ""
