"""Port shading, scatter, Russian roulette and one wavefront bounce,
lane by lane against the JAX functions given identical inputs (the
same hit arrays on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracer_tpu.models import materials as jmats
from sycl_ray_tracer_tpu.models import trace as jtrace
from sycl_ray_tracer_tpu.models import wavefront as jwf
from sycl_ray_tracer_tpu.models.scene import build_device_scene as jbuild
from sycl_ray_tracer_tpu.ops import rng as jrng
from sycl_ray_tracer_tpu.ops.intersect import Hit as JHit
from sycl_ray_tracer_tpu.utils.gltf import load_glb as jload
from sycl_ray_tracer_tpu.utils.procgen import sponza_like_glb as jsponza
from sycl_ray_tracer_torch.models import materials as tmats
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models import wavefront as twf
from sycl_ray_tracer_torch.ops.intersect import Hit
from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb

from tests.torch_common import jv3, np3, port_pair, tv3

W, H = 64, 64
_STATE = {}


def _setup():
    """Sponza scale 1 (diffuse textured, metal, glass, emissive) on both
    sides, a 64x64 camera queue of the port, and its hits."""
    if not _STATE:
        host, scene, cam = port_pair(sponza_like_glb(scale=1), W, H)
        js = jbuild(jload(jsponza(scale=1)), leaf_size=8)
        q, q_id = twf._gen_queue(cam, 3, 0, width=W, height=H)
        hit = ttrace.intersect_scene(scene, *(tv3(q[0:3].T.numpy()),
                                              tv3(q[3:6].T.numpy())))
        _STATE.update(host=host, scene=scene, js=js, q=q, q_id=q_id,
                      hit=hit)
    return _STATE


def _jhit(hit: Hit) -> JHit:
    return JHit(t=jnp.asarray(hit.t.numpy()),
                tri=jnp.asarray(hit.tri.numpy().astype(np.int32)),
                u=jnp.asarray(hit.u.numpy()), v=jnp.asarray(hit.v.numpy()))


def test_shade_lanes_match():
    st = _setup()
    hit = st["hit"]
    assert (hit.tri >= 0).float().mean() > 0.5
    n, uu, vv, mat = ttrace.shade_lanes(st["scene"], hit)
    jn, juu, jvv, jmat = jtrace.shade_lanes(st["js"], _jhit(hit))
    ok = hit.tri.numpy() >= 0
    np.testing.assert_allclose(np3(n)[ok], np3(jn)[ok], rtol=0, atol=1e-6)
    np.testing.assert_allclose(uu.numpy(), np.asarray(juu), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(vv.numpy(), np.asarray(jvv), rtol=0,
                               atol=1e-6)
    for f in ("mtype", "tex", "rough", "ior"):
        assert (getattr(mat, f).numpy() == np.asarray(getattr(jmat, f))).all()
    for f in ("albedo", "emissive"):
        assert (np3(getattr(mat, f)) == np3(getattr(jmat, f))).all()
    # every material kind of the scene is on screen
    kinds = set(mat.mtype.numpy()[ok].tolist())
    assert kinds == {0, 1, 2}


@pytest.mark.parametrize("counter", [2, 7])
def test_scatter_and_texture_match(counter):
    st = _setup()
    hit = st["hit"]
    n, uu, vv, mat = ttrace.shade_lanes(st["scene"], hit)
    d = st["q"][3:6].T.numpy()
    d_unit = d / np.linalg.norm(d, axis=1, keepdims=True)
    keys = jrng.make_key_np(np.uint32(5), np.arange(W * H, dtype=np.uint32))
    tkeys = torch.from_numpy(keys.astype(np.int64))
    ok = hit.tri.numpy() >= 0

    tex = tmats.albedo_lanes(st["scene"], mat, uu, vv)
    jmat = jmats.MatLanes(
        mtype=jnp.asarray(mat.mtype.numpy().astype(np.int32)),
        albedo=jv3(np3(mat.albedo)),
        tex=jnp.asarray(mat.tex.numpy().astype(np.int32)),
        rough=jnp.asarray(mat.rough.numpy()),
        ior=jnp.asarray(mat.ior.numpy()),
        emissive=jv3(np3(mat.emissive)))
    jtex = jmats.albedo_lanes(st["js"], jmat, jnp.asarray(uu.numpy()),
                              jnp.asarray(vv.numpy()))
    assert (np3(tex) == np3(jtex)).all()
    assert (mat.tex.numpy()[ok] >= 0).mean() > 0.3  # textures sampled

    cont, nd, att = tmats.scatter(st["scene"], mat, tv3(d_unit), n, uu, vv,
                                  tkeys, counter)
    jcont, jnd, jatt = jmats.scatter(
        st["js"], jmat, jv3(d_unit), jv3(np3(n)), jnp.asarray(uu.numpy()),
        jnp.asarray(vv.numpy()), jnp.asarray(keys), counter)
    assert (cont.numpy()[ok] == np.asarray(jcont)[ok]).all()
    np.testing.assert_allclose(np3(nd)[ok], np3(jnd)[ok], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np3(att)[ok], np3(jatt)[ok], rtol=0,
                               atol=1e-6)
    assert 0.05 < cont.numpy()[ok].mean() < 1.0


def test_rr_survive_match():
    rs = np.random.RandomState(4)
    att = rs.uniform(0.0, 1.2, (4096, 3)).astype(np.float32)
    keys = jrng.make_key_np(np.uint32(9), np.arange(4096, dtype=np.uint32))
    surv, scaled = ttrace.rr_survive(tv3(att),
                                     torch.from_numpy(keys.astype(np.int64)),
                                     6)
    jsurv, jscaled = jtrace.rr_survive(jv3(att), jnp.asarray(keys), 6)
    assert (surv.numpy() == np.asarray(jsurv)).all()
    assert 0.2 < surv.numpy().mean() < 0.9
    np.testing.assert_allclose(np3(scaled), np3(jscaled), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bounce_idx,rr", [(0, False), (4, True)])
def test_bounce_matches_jax(monkeypatch, bounce_idx, rr):
    """One port bounce against JAX _bounce, both handed the same hits
    through a monkeypatched intersector. One sample per pixel, so each
    terminated lane's contribution lands alone in its pixel."""
    st = _setup()
    hit = st["hit"]
    rs = np.random.RandomState(bounce_idx)
    q = st["q"].clone()
    q[6:9] = torch.from_numpy(rs.uniform(0.05, 1.0, (3, W * H)).astype(
        np.float32))
    q[9:12] = torch.from_numpy(rs.uniform(0.0, 0.3, (3, W * H)).astype(
        np.float32))
    q_id = st["q_id"]
    seed, sofs = 3, 5

    keys = {}

    def spy(name, real):
        def f(scene, o, d, *a, **kw):
            k = real(scene, o, d, *a, **kw)
            keys[name] = np.asarray(k).astype(np.int64)
            return k
        return f

    monkeypatch.setattr(ttrace, "intersect_scene",
                        lambda scene, o, d, active=None: hit)
    monkeypatch.setattr(twf, "_coherence_key",
                        spy("port", twf._coherence_key))
    acc = torch.zeros((W * H, 3))
    q2, q_id2 = twf._bounce(st["scene"], q, q_id, bounce_idx, acc, seed,
                            sofs, rr=rr)

    jh = _jhit(hit)
    monkeypatch.setattr(jtrace, "intersect_scene",
                        lambda scene, o, d, active=None, primary=False: jh)
    monkeypatch.setattr(jwf, "_coherence_key",
                        spy("jax", jwf._coherence_key))
    n = W * H
    carry = tuple(jnp.asarray(q[i].numpy()) for i in range(12)) + (
        jnp.asarray(q_id.numpy().astype(np.int32)), jnp.int32(n),
        jnp.zeros((n, 3), jnp.float32), jnp.zeros((1,), jnp.int32))
    out = jwf._bounce(st["js"], None, carry, bounce_idx, n, rr=rr,
                      key_seed=(jnp.uint32(seed), jnp.uint32(sofs),
                                jnp.uint32(0)))
    count = int(out[13])

    # alive / terminated masks: the same lanes survive
    assert q_id2.numel() == count
    assert 0 < count < n
    alive = np.zeros(n, bool)
    alive[q_id2.numpy()] = True
    jalive = np.zeros(n, bool)
    jalive[np.asarray(out[12])[:count]] = True
    assert (alive == jalive).all()
    # contributions of the terminated lanes (and nothing from the alive)
    np.testing.assert_allclose(acc.numpy(), np.asarray(out[14]), rtol=0,
                               atol=1e-6)
    assert (acc.numpy()[alive] == 0).all()
    # coherence keys of the surviving lanes
    assert (keys["port"][alive] == keys["jax"][alive]).all()
    # the compacted queues: same order (same keys, stable sort), same rays
    assert (q_id2.numpy() == np.asarray(out[12])[:count]).all()
    jq = np.stack([np.asarray(out[i])[:count] for i in range(12)])
    np.testing.assert_allclose(q2.numpy(), jq, rtol=1e-6, atol=1e-6)
