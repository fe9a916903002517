"""Port intersector against the Pallas kernel it replaces
(traverse_packets8) run in interpret mode on the CPU, through the same
pallas_call patch as tests/test_pallas.py."""

import jax.numpy as jnp
import numpy as np

from sycl_ray_tracer_tpu.ops import sah as jsah
from sycl_ray_tracer_tpu.ops import wbvh as jwbvh
from sycl_ray_tracer_tpu.ops import woop as jwoop
from sycl_ray_tracer_tpu.ops.vec import V3 as JV3
from sycl_ray_tracer_tpu.utils.fixtures import cube_scene_glb
from sycl_ray_tracer_tpu.utils.gltf import load_glb
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.ops.traverse8 import traverse8_plain
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils import gltf as tgltf

from tests.torch_common import tv3


def test_plain_matches_traverse_packets8_interpret():
    import sycl_ray_tracer_tpu.ops.traverse_pallas8 as TP8

    host = load_glb(cube_scene_glb())
    sahb = jsah.build_sah(host.tri_v, 8)
    rows = jsah.leaf_rows(host.tri_v, sahb.order, 8)
    ct, _ = jwbvh.pack_tiles_np(sahb.children, sahb.child_ids, rows, 8)
    wt = jwoop.pack_wtiles_affine_np(rows)

    rs = np.random.RandomState(3)
    r = 1024
    o = np.broadcast_to(np.asarray(host.camera_position, np.float32),
                        (r, 3)).copy()
    d = rs.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jo = JV3(*(jnp.asarray(o[:, i]) for i in range(3)))
    jd = JV3(*(jnp.asarray(d[:, i]) for i in range(3)))

    orig = TP8.pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    TP8.pl.pallas_call = patched
    try:
        ref = TP8.traverse_packets8(jnp.asarray(ct), jnp.asarray(wt),
                                    sahb.num_internal, 8, jo, jd)
        ref2 = TP8.traverse_packets8(jnp.asarray(ct), jnp.asarray(wt),
                                     sahb.num_internal, 8, jo, jd,
                                     t_init=ref.t)
    finally:
        TP8.pl.pallas_call = orig

    scene = build_device_scene(tgltf.load_glb(tfix.cube_scene_glb()))
    assert scene.sah_ni == sahb.num_internal
    args = (scene.bvh_nodes, scene.bvh_child_ids, scene.bvh_woop,
            scene.sah_ni, tv3(o), tv3(d))
    hit = traverse8_plain(*args)
    tri, rtri = hit.tri.numpy(), np.asarray(ref.tri)
    assert ((tri < 0) == (rtri < 0)).all()
    both = rtri >= 0
    assert both.mean() > 0.2
    assert (tri[both] == rtri[both]).all()
    np.testing.assert_allclose(hit.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hit.u.numpy()[both], np.asarray(ref.u)[both],
                               atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[both], np.asarray(ref.v)[both],
                               atol=1e-4)
    # t_init chaining gives no hit on either side
    assert (np.asarray(ref2.tri) == -1).all()
    again = traverse8_plain(*args, t_init=hit.t)
    assert (again.tri.numpy() == -1).all()
