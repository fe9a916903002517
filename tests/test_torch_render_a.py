"""Port render_wavefront on the CPU against the JAX package's numpy
oracle (the flip-tolerant gate of tests/test_render.py) and its
per-bounce ray tallies against JAX render_wavefront on the CPU: equal
to within 0.5 % per bounce or 16 rays, whichever is larger (the FMA
flip tail)."""

import numpy as np

from sycl_ray_tracer_tpu.models.oracle import render_oracle
from sycl_ray_tracer_tpu.models.wavefront import render_wavefront as jrender
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.utils import fixtures as tfix

from tests import scenes
from tests.test_render import check_oracle_match
from tests.torch_common import port_pair


def render_and_check(name, width, height, spp, max_depth, rr=False):
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=0, rr=rr)
    _, scene, cam = port_pair(getattr(tfix, name)(), width, height)
    img, rays = render_wavefront(scene, cam, **kw)
    img, rays = img.numpy(), rays.numpy()
    assert img.shape == (height, width, 3) and rays.dtype == np.int64

    js, jhost, jcam = scenes.load_pair(getattr(scenes, name)(), width,
                                       height)
    oracle = render_oracle(jhost, jcam, **kw)
    check_oracle_match(img, oracle)
    _, jrays = jrender(js, jcam, **kw)
    jrays = np.asarray(jrays).astype(np.int64)
    slack = np.maximum(16, 0.005 * jrays)
    assert (np.abs(rays - jrays) <= slack).all(), (rays, jrays)
    assert rays[0] == width * height * spp
    return img, rays


def test_triangle_1spp():
    img, _ = render_and_check("triangle_scene_glb", 256, 256, 1, 5)
    assert img.max() > 0.3 and img.std() > 0.01


def test_cube_multibounce_4spp():
    _, rays = render_and_check("cube_scene_glb", 96, 96, 4, 8)
    assert rays[3] > 0


def test_textured():
    img, _ = render_and_check("textured_scene_glb", 64, 64, 4, 4)
    assert img[..., 0].max() > 0.5 and img[..., 2].max() > 0.5


def test_image_does_not_depend_on_wave_size(monkeypatch):
    """Per-lane keys come from (q_id, sample offset), so cutting the
    samples into several waves renders the same paths: equal tallies,
    and images equal up to the order of the float sums."""
    import sycl_ray_tracer_torch.models.wavefront as wf

    assert wf._wave_samples(64, 1024 * 1024) == 64
    assert wf._wave_samples(128, 1920 * 1080) == (64 << 20) // (1920 * 1080)
    _, scene, cam = port_pair(tfix.cube_scene_glb(), 64, 64)
    kw = dict(width=64, height=64, spp=6, max_depth=6, seed=2)
    one, rays_one = render_wavefront(scene, cam, **kw)
    offsets = []
    real = wf._gen_queue

    def spy(cam_, seed, s, **k):
        offsets.append(s)
        return real(cam_, seed, s, **k)

    monkeypatch.setattr(wf, "_gen_queue", spy)
    monkeypatch.setattr(wf, "_wave_samples", lambda spp, n: 4)
    many, rays_many = render_wavefront(scene, cam, **kw)
    assert offsets == [0, 4]
    assert (rays_one == rays_many).all()
    np.testing.assert_allclose(one.numpy(), many.numpy(), rtol=0, atol=1e-6)
