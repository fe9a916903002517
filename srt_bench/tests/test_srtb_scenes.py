"""The frozen generators give the port's bytes, and the configurations'
stated sizes are what the reference reads from them."""

import json
import os

import numpy as np
import pytest

from srt_bench import cells
from srt_bench.reference import ingest
from srt_bench.scenes import atrium
from srt_bench.scenes import procgen as frozen
from sycl_ray_tracer_torch.utils import procgen as port


@pytest.mark.parametrize("fn, args", [
    ("sponza_like_glb", {"scale": 1}),
    ("sponza_like_glb", {"scale": 2, "seed": 0}),
    ("minecraft_like_glb", {"n": 72}),
    ("minecraft_like_glb", {"n": 360, "seed": 3}),
])
def test_frozen_generators_give_the_ports_bytes(fn, args):
    assert getattr(frozen, fn)(**args) == getattr(port, fn)(**args)


def _config(name):
    with open(os.path.join(cells.HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config, key", [("sponza_proc", "triangles"),
                                         ("minecraft_proc",
                                          "world_triangles")])
def test_config_sizes_are_what_the_reference_reads(config, key):
    c = _config(config)
    s = ingest.load(cells.scene_bytes(c))
    assert s.tri_v.shape[0] == c[key]
    assert s.textures.shape[1:] == (512, 512, 4)
    if "images" in c:
        assert s.textures.shape[0] == c["images"]


def test_atrium_is_all_diffuse_and_finely_meshed():
    """Every material of the atrium is diffuse, textured with an image
    of its own, and emits nothing; no triangle is larger than a face of
    the largest box of clutter (the walls, floor, roofs and balconies
    are tiles of at most 1 x 1, never single quads of up to 60 x 24)."""
    s = ingest.load(atrium.sponza_atrium_glb(scale=1, seed=0, court=2.4,
                                             texture_res=64))
    used = np.unique(s.tri_mat)
    assert (s.mtype[used] == ingest.MAT_DIFFUSE).all()
    assert (s.emissive == 0).all()
    assert sorted(s.tex_id[used]) == list(range(len(atrium.MATERIALS)))
    assert s.textures.shape == (len(atrium.MATERIALS), 512, 512, 4)
    e1 = s.tri_v[:, 1] - s.tri_v[:, 0]
    e2 = s.tri_v[:, 2] - s.tri_v[:, 0]
    area = np.linalg.norm(np.cross(e1, e2), axis=1) / 2
    assert area.max() < 1.6 * 1.6 / 2 + 1e-3
