"""Port render_wavefront on the dielectric fixture (BASELINE config 3),
with and without Russian roulette, against the JAX oracle and tallies
(see test_torch_render_a.py)."""

from tests.test_torch_render_a import render_and_check


def test_dielectric_16spp():
    render_and_check("dielectric_scene_glb", 64, 64, 16, 12)


def test_dielectric_russian_roulette():
    _, rays_rr = render_and_check("dielectric_scene_glb", 64, 64, 16, 12,
                                  rr=True)
    _, rays = render_and_check("dielectric_scene_glb", 64, 64, 16, 4)
    # RR only starts at bounce 3, and then kills paths
    assert (rays_rr[:3] == rays[:3]).all()
    assert rays_rr[3] == rays[3] and rays_rr[4:].sum() < rays_rr[3] * 8
