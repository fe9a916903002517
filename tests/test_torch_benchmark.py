"""The port's measuring entry points on the CPU: benchmark_torch.py's
helpers against benchmark.py's on the cases of tests/test_benchmark.py,
its sweep in process and in subprocess mode, bench_torch.py's JSON
line, the refusal of both scripts without CUDA, the stage ranges in a
profiler trace, the CLI's SRT_TRACE_DIR trace, and SRT_INSTANCED_R."""

import csv
import importlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from sycl_ray_tracer_torch.models.megakernel import render_megakernel
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils.cli import resolve_scene_bytes
from sycl_ray_tracer_torch.utils.instanced import load_glb_instanced

from tests.torch_common import port_pair

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
benchmark = importlib.import_module("benchmark")
benchmark_torch = importlib.import_module("benchmark_torch")

_RAW_COLUMNS = ["renderer", "scene", "res", "depth", "samples", "run",
                "time_s", "mrays_per_sec", "total_rays"]
_AVG_COLUMNS = ["renderer", "scene", "res", "depth", "samples", "time_s",
                "mrays_per_sec", "total_rays"]
# the in-process sweep's config: at depth 3 the cube's totals are equal
# for every seed, at depth 4 they differ, so a run on the wrong seed shows
_SWEEP = ["--scenes", "cube", "--pairs", "4:2", "--resolutions", "32x24",
          "--device", "cpu"]
_KW = dict(width=32, height=24, spp=2, max_depth=4)


def _run(args, env=None, timeout=180, cwd=_ROOT):
    env = dict(os.environ, PYTHONPATH=_ROOT, **(env or {}))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# --- the helpers, on the cases of tests/test_benchmark.py ---

def _merge_redone(mod):
    old = [
        ["wavefront", "sponza_proc", "512x512", "10", "128", 1.0, 4.0, 100],
        ["wavefront", "sponza_proc", "512x512", "10", "128", 1.1, 4.1, 100],
        ["wavefront", "sponza_proc", "512x512", "20", "128", 2.0, 3.0, 200],
    ]
    new = [["wavefront", "sponza_proc", "512x512", 10, 128, 0.9, 5.0, 100]]
    return mod._merge(old, new)


def _merge_resolution(mod):
    old = [["wavefront", "sponza_proc", "512x512", "10", "128", 1.0, 4.0, 1]]
    new = [["wavefront", "sponza_proc", "1024x1024", 10, 128, 4.0, 4.4, 4]]
    return mod._merge(old, new)


def _merge_empty(mod):
    return mod._merge([], [["megakernel", "cube", "64x48", 2, 1, 0.1, 0.5,
                            10]])


def _merge_nan(mod):
    old = [["wavefront", "cube", "64x48", "10", "128", "1.1", "4.1", "9"]]
    nan_new = [["wavefront", "cube", "64x48", 10, 128, "nan", "nan", "nan"]]
    other = [["wavefront", "cube", "64x48", "20", "128", "2", "3", "9"]]
    return mod._merge(old, nan_new), mod._merge(other, nan_new)


def _read_legacy(mod):
    # a row one column short (no res) in the avg file, no raw file; each
    # module reads its own file names
    name = "benchmark_avg.csv" if mod is benchmark else mod.AVG_CSV
    with open(name, "w") as f:
        f.write("renderer,scene,depth,samples,time_s,mrays,total\n")
        f.write("wavefront,sponza_proc,10,128,30.0,4.2,1000\n")
    return mod._read_csvs()


def _append_partial_failure(mod, monkeypatch):
    """Run 0 lands, run 1 raises: the old CSVs stay, both intact."""
    old_raw = [
        ["wavefront", "cube", "64x48", "10", "128", "0", "1.0", "4.0", "100"],
        ["wavefront", "cube", "64x48", "10", "128", "1", "1.1", "4.1", "100"],
    ]
    old_avg = [["wavefront", "cube", "64x48", "10", "128", "1.1", "4.1",
                "100"]]
    mod._write_csvs(old_raw, old_avg)

    def fake_run_once(scene, flag, d, s, width, height, timeout=None,
                      seed=0, devices=1, **kw):
        if seed == 0:
            return 1.0, 100, 0.1
        raise RuntimeError("device stall")

    monkeypatch.setattr(mod, "run_once", fake_run_once)
    argv = ["--append", "--scenes", "cube", "--renderers", "wavefront",
            "--pairs", "10:128", "--width", "64", "--height", "48",
            "--runs", "2"]
    if mod is benchmark:
        monkeypatch.setattr(sys, "argv", ["benchmark.py"] + argv)
        mod.main()
    else:
        mod.main(argv + ["--device", "cpu"])
    return mod._read_csvs(), (old_raw, old_avg)


def _stall_outlier(mod):
    return mod._stall_warning([(157.5, 3.69, 581e6), (4469.9, 0.13, 581e6)])


def _stall_quiet(mod):
    return (mod._stall_warning([(157.5, 3.69, 581e6), (157.8, 3.68, 581e6)]),
            mod._stall_warning([(157.5, 3.69, 581e6)]))


_CASES = {
    "merge_replaces_all_rows_of_redone_config": _merge_redone,
    "merge_key_includes_resolution": _merge_resolution,
    "merge_without_old_rows_is_identity": _merge_empty,
    "read_csvs_upgrades_legacy_schema": _read_legacy,
    "merge_nan_row_never_evicts_measured_data": _merge_nan,
    "append_partial_failure_keeps_csvs_consistent": _append_partial_failure,
    "stall_warning_flags_outlier_run": _stall_outlier,
    "stall_warning_quiet_on_normal_spread": _stall_quiet,
}


@pytest.mark.parametrize("case", list(_CASES))
def test_helpers_match_reference(case, tmp_path, monkeypatch):
    """benchmark_torch.py's _merge, _read_csvs, _write_csvs and
    _stall_warning give what benchmark.py's give on the same rows."""
    fn = _CASES[case]
    extra = ((monkeypatch,) if case.startswith("append") else ())
    got = {}
    for mod in (benchmark, benchmark_torch):
        d = tmp_path / mod.__name__
        d.mkdir()
        monkeypatch.chdir(d)
        got[mod.__name__] = fn(mod, *extra)
    assert got["benchmark_torch"] == got["benchmark"]
    ref = got["benchmark"]
    if case.startswith("append"):
        assert ref[0] == ref[1]  # old rows intact, no stray warm-up row
    elif case == "stall_warning_flags_outlier_run":
        assert ref is not None and "stall" in ref
    assert not (tmp_path / "benchmark_torch" / "benchmark_raw.csv").exists()


# --- the sweep ---

def test_inproc_sweep_on_cpu(tmp_path, monkeypatch, capsys):
    """Both CSVs with the reference's columns; run 0 printed as discarded
    and left out of the average; each run's total equal to the port's
    render of its seed, and seed 0's to the JAX package's tallies."""
    from sycl_ray_tracer_tpu.models.wavefront import (render_wavefront as
                                                      jrender)
    from tests import scenes

    monkeypatch.chdir(tmp_path)
    benchmark_torch.main(_SWEEP + ["--inproc", "--runs", "2", "--renderers",
                                   "wavefront", "megakernel"])
    out = capsys.readouterr().out
    raw, avg = _read(benchmark_torch.RAW_CSV), _read(benchmark_torch.AVG_CSV)
    assert raw[0] == _RAW_COLUMNS and avg[0] == _AVG_COLUMNS
    assert not os.path.exists("benchmark_raw.csv")
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 32, 24)
    want = [int(render_wavefront(scene, cam, seed=r, **_KW)[1].sum())
            for r in range(3)]
    assert len(set(want)) == 3
    for renderer in ("wavefront", "megakernel"):
        rows = [r for r in raw[1:] if r[0] == renderer]
        assert [r[1:6] for r in rows] == [["cube", "32x24", "4", "2", str(k)]
                                          for k in range(3)]
        assert [int(r[8]) for r in rows] == want
        (a,) = [r for r in avg[1:] if r[0] == renderer]
        assert [float(x) for x in a[5:]] == [
            statistics.mean(float(r[i]) for r in rows[1:]) for i in (6, 7, 8)]
        assert (f"cube {renderer} 32x24 d=4 s=2 run=0: " in out
                and out.count("(warm-up, discarded)") == 2)

    js, _, jcam = scenes.load_pair(scenes.cube_scene_glb(), 32, 24)
    _, jrays = jrender(js, jcam, seed=0, **_KW)
    assert int(np.asarray(jrays).astype(np.int64).sum()) == want[0]


def test_subprocess_sweep_scrapes_cli(tmp_path):
    """One CLI process per run: the contract lines are scraped into the
    CSVs, each run on its own seed."""
    p = _run([os.path.join(_ROOT, "benchmark_torch.py")] + _SWEEP
             + ["--runs", "1", "--renderers", "wavefront"], cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    raw = _read(tmp_path / "benchmark_torch_raw.csv")
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 32, 24)
    assert [int(r[8]) for r in raw[1:]] == [
        int(render_wavefront(scene, cam, seed=r, **_KW)[1].sum())
        for r in range(2)]
    assert all(float(r[6]) > 0 for r in raw[1:])
    assert not (tmp_path / "out.png").exists()


def test_inproc_refuses_devices(tmp_path):
    p = _run([os.path.join(_ROOT, "benchmark_torch.py"), "--inproc",
              "--devices", "2"] + _SWEEP, cwd=tmp_path)
    assert p.returncode != 0 and "--devices with --inproc" in p.stderr


def test_bench_torch_json_on_cpu():
    p = _run(["bench_torch.py", "--device", "cpu"],
             env=dict(BENCH_SCENE_SCALE="1", BENCH_RES="16", BENCH_SPP="1",
                      BENCH_DEPTH="2", BENCH_RUNS="3"))
    assert p.returncode == 0, p.stderr
    head = json.loads(p.stdout.strip().splitlines()[-1])
    assert head["unit"] == "Mrays/s"
    assert head["n_runs"] == len(head["runs"]) == 3
    assert head["value"] == head["median"] == statistics.median(head["runs"])
    assert head["spread"] == max(head["runs"]) - min(head["runs"])
    assert head["device"] == "cpu" and "torch cpu" in head["metric"]
    assert "vs_baseline" not in head
    assert all(t >= 16 * 16 for t in head["totals"])


@pytest.mark.parametrize("script", ["bench_torch.py", "benchmark_torch.py"])
def test_scripts_refuse_missing_cuda(script, tmp_path):
    """Without --device cpu on a machine without CUDA, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p = _run([os.path.join(_ROOT, script)], cwd=tmp_path, timeout=60)
    assert p.returncode != 0 and "CUDA is not available" in p.stderr
    assert not list(tmp_path.iterdir())


# --- the trace ranges ---

_ENGINES = {"wavefront": (render_wavefront,
                          ("generate", "intersect", "shade", "scatter",
                           "accumulate", "compact")),
            "megakernel": (render_megakernel,
                           ("generate", "count", "intersect", "shade",
                            "scatter", "accumulate"))}


@pytest.mark.parametrize("engine", list(_ENGINES))
def test_stage_ranges_in_profiler(engine):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    render, stages = _ENGINES[engine]
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 32, 24)
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, cam, seed=0, **_KW)
    names = {e.key for e in prof.key_averages()}
    assert {f"srt.{s}" for s in stages} <= names, names


def test_cli_trace_dir_writes_trace(tmp_path):
    trace = tmp_path / "trace"
    p = _run(["-m", "sycl_ray_tracer_torch", "triangle", "--device", "cpu",
              "-s", "1", "-d", "2", "--width", "16", "--height", "12", "-o",
              str(tmp_path / "img.png")], env={"SRT_TRACE_DIR": str(trace)})
    assert p.returncode == 0, p.stderr
    assert "Total rays: " in p.stdout and "[trace] " in p.stdout
    with open(trace / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert {"srt.intersect", "srt.compact"} <= {e.get("name") for e in events}


def test_instanced_r_sets_cube_count(monkeypatch):
    monkeypatch.setenv("SRT_INSTANCED_R", "30")
    host = load_glb_instanced(resolve_scene_bytes("instanced_proc"))
    ref = load_glb_instanced(tfix.instanced_scene_glb(30))
    assert host.num_instances == ref.num_instances
    assert host.num_world_triangles == ref.num_world_triangles
    assert host.num_instances < load_glb_instanced(
        tfix.instanced_scene_glb(31)).num_instances
