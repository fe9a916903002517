"""A run with the timed path broken underneath reads `correct` false.

Each test drives the harness's run (run.run_cell) on the CPU at the
small size of conftest.py, past the look for a card, with the cell's
own limits, once sound and once with each fault the cell can have:
- a step that returns its state unchanged (the wavefront's bounce, the
  megakernel's path step);
- half of the samples left out, the mean taken over the rest;
- the exchange between ranks left out (the four-card cell);
- the answer altered where it is produced (the frame's channels
  reversed).
"""

import contextlib
import time

import pytest
import torch.distributed as dist

from srt_bench import cells, run

SEED = 2 ** 31 + 77


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def sound(render):
    return render


def state_unchanged(render):
    from sycl_ray_tracer_torch.models import trace, wavefront

    def bounce(scene, q, q_id, *a, **kw):
        return q, q_id

    def step(scene, state, *a, **kw):
        return state

    def wrapped(*a, **kw):
        with _patched(wavefront, "_bounce", bounce), \
                _patched(trace, "trace_step", step):
            return render(*a, **kw)
    return wrapped


def half_the_samples(render):
    def wrapped(*a, spp, **kw):
        return render(*a, spp=spp // 2, **kw)
    return wrapped


def no_exchange(render):
    def wrapped(*a, **kw):
        with _patched(dist, "all_reduce", lambda *x, **y: None):
            return render(*a, **kw)
    return wrapped


def answer_altered(render):
    def wrapped(*a, **kw):
        img, rays = render(*a, **kw)
        return img.flip(-1), rays
    return wrapped


def _run(small, cell_name, wrap):
    bench, data = small
    cell = cells.load(cell_name, bench, data)
    devices = ["cpu"] * cell.chips
    if cell.chips == 1:
        return run.run_rank(0, "cpu", cell, SEED, 0.2, False, time.time(),
                            render_wrap=wrap)
    return run.run_cell(cell, SEED, 0.2, False, time.time(), devices,
                        backend="gloo", render_wrap=wrap)


ONE_CARD = ["sponza_proc.wavefront", "sponza_proc.megakernel"]
FAULTS = [state_unchanged, half_the_samples, answer_altered]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_run_is_correct(small, cell):
    assert _run(small, cell, sound)["correct"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ONE_CARD)
def test_fault_is_refused(small, cell, fault):
    r = _run(small, cell, fault)
    assert not r["correct"] and r["failed"] == 1, r["checks"]


@pytest.mark.parametrize("fault", [sound, no_exchange, half_the_samples,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_four_rank_cell(small, fault):
    r = _run(small, "sponza_proc.wavefront.4card", fault)
    assert r["correct"] == (fault is sound), r["checks"]
