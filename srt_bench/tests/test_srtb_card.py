"""The harness and the control on the card, at the small size of
conftest.py: a sound run through the port's CUDA kernels is correct,
with the cells' limits, and the bfloat16 control is refused. They skip
without a card (the decision is made inside each test)."""

import time

import pytest
import torch

from srt_bench import cells, check, control, run


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sponza_proc.wavefront",
                                  "sponza_proc.megakernel"])
def test_sound_run_on_the_card(small, cell):
    device = _card()
    bench, data = small
    r = run.run_rank(0, device, cells.load(cell, bench, data), 2 ** 31 + 9,
                     0.5, True, time.time())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sponza_proc.wavefront",
                                  "sponza_proc.megakernel"])
def test_control_refused_on_the_card(small, cell):
    device = _card()
    bench, data = small
    checks = control.readings(cells.load(cell, bench, data), 11, device)
    assert not check.passed(checks), checks
