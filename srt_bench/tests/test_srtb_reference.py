"""The plain reference against the port's own renders of small frames
on the CPU, and the control against the cells' limits."""

import numpy as np
import pytest
import torch

from srt_bench import cells, check, control
from srt_bench.reference import ingest
from srt_bench.reference.render import DeviceRef, camera, render_pixels

SEED = 3_000_000_017 * 1000 + 5


def _port_frame(glb, two_level, engine, width, height, spp, depth, seed):
    from sycl_ray_tracer_torch.models.camera import make_camera
    from sycl_ray_tracer_torch.models.renderer import get_renderer
    from sycl_ray_tracer_torch.utils.cli import load_scene

    scene, host = load_scene(glb, "cpu", two_level, log=lambda *a: None)
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device="cpu")
    img, rays = get_renderer(engine)(scene, cam, width=width, height=height,
                                     spp=spp, max_depth=depth, seed=seed)
    return img.reshape(-1, 3).numpy(), rays.numpy()


@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
@pytest.mark.parametrize("config, two_level", [("sponza_proc", False),
                                               ("minecraft_proc", True)])
def test_reference_agrees_with_the_port(small, config, two_level, engine):
    """The configurations' own generators at the small size; the
    sponza_proc images are resized on both sides."""
    bench, data = small
    cell = cells.load("sponza_proc.wavefront", bench, data)
    cell.config = cells._json(f"{data}/configs/{config}.json")
    glb = cells.scene_bytes(cell.config)
    w, h, spp, depth = 40, 30, 8, 6
    ours, rays = _port_frame(glb, two_level, engine, w, h, spp, depth, SEED)
    rs = ingest.load(glb)
    lane = torch.arange(w * h)
    ref, tallies = render_pixels(DeviceRef(rs, "cpu"), camera(rs, w, h, "cpu"),
                                 lane % w, lane // w, width=w, spp=spp,
                                 max_depth=depth, seed=SEED)
    paths = w * h * spp
    c = check.compare(ours, ref.numpy(), rays, tallies.numpy(), paths, paths,
                      {"pixel_q90": 0.0, "tally_gap": 0.0})
    # the same pixels on both sides: only paths that flip at a tie differ
    assert c["pixel_q90"]["value"] < 5e-3
    assert c["tally_gap"]["value"] < 5e-3
    assert np.abs(ours - ref.numpy()).max(1).mean() < 0.01


@pytest.mark.parametrize("cell", ["sponza_proc.wavefront",
                                  "sponza_proc.megakernel"])
def test_control_is_refused(small, cell):
    """The bfloat16 control at the small size fails the cell's limits."""
    bench, data = small
    c = cells.load(cell, bench, data)
    checks = control.readings(c, 11, torch.device("cpu"))
    assert not check.passed(checks), checks
