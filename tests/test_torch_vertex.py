"""The bounce stages' per-lane code (csrc/vertex.cuh), built by g++
(csrc/vertex_host.cpp), against the plain torch stages lane by lane on
the CPU: the RNG draws, shade_lanes with the texel, materials.scatter,
rr_survive, one megakernel trace_step and one wavefront _bounce, on a
textured SAH scene with every material (sponza scale 1), the two-level
instanced fixture, and a scene without textures on the Morton heap
(int32 hit ids), with russian roulette off and on.

RNG words and floats are compared bit for bit (NaN equal to NaN), with
one tolerance. g++ contracts no multiply-add (-ffp-contract=off), and
where the stages take rsqrt the host build divides 1 by sqrtf, as
torch's CPU kernel does (equal on 1M random inputs). But torch's CPU
sqrt is not correctly rounded (it differs from sqrtf by one ulp on
about 0.6 % of random inputs), and g++'s is. The one sqrt on the way to
a float output is a dielectric's refraction (refract's r_out_parallel;
the other sqrt only feeds a comparison), so a refracted direction may
differ by SQRT_ATOL per component: about two ulps at the scale of a unit
vector, an ulp of the sqrt carried through one multiply and one add.
Everything else, those lanes' other columns included, is bit-equal. On
the card the kernel calls rsqrtf and a correctly rounded sqrtf, as
torch's CUDA kernels do (tests/test_torch_cuda.py holds it to the plain
stages there)."""

import ctypes

import numpy as np
import pytest
import torch

from sycl_ray_tracer_torch.models import materials as tmats
from sycl_ray_tracer_torch.models import trace as ttrace
from sycl_ray_tracer_torch.models import wavefront as twf
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.instanced import (
    build_instanced_device_scene)
from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops import rng as trng
from sycl_ray_tracer_torch.ops import vertex
from sycl_ray_tracer_torch.ops.intersect import Hit
from sycl_ray_tracer_torch.ops.sampling import random_unit_vector
from sycl_ray_tracer_torch.ops.vec import V3, normalize
from sycl_ray_tracer_torch.utils import fixtures as tfix
from sycl_ray_tracer_torch.utils.instanced import load_glb_instanced
from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb

from tests.torch_common import port_pair

W, H = 48, 32
SEED = (1 << 40) + 12345   # above 32 bits: the stages keep the low word
SAMPLE_OFFSET = 5
_P = ctypes.c_void_p
SQRT_ATOL = 2.5e-7
_SCENES = ("sponza", "instanced", "untextured")
_CACHE = {}


def _scene(name):
    """(scene, camera queue of two samples a pixel [12, 2WH], q_id, its
    hits) on the CPU; attenuation and radiance drawn at random."""
    if name not in _CACHE:
        if name == "sponza":
            _, scene, cam = port_pair(sponza_like_glb(scale=1), W, H)
        elif name == "instanced":
            ih = load_glb_instanced(tfix.instanced_scene_glb(30))
            scene = build_instanced_device_scene(ih, device="cpu")
            cam = make_camera(W, H, ih.camera_position, ih.camera_direction,
                              ih.camera_focal_length, device="cpu")
        else:
            scene, _, cam = tfix.load_pair(tfix.dielectric_scene_glb(), W, H,
                                           leaf_size=4, device="cpu")
        q, q_id = twf._gen_queue(cam, 3, 0,
                                 pixels=twf.frame_pixels(W, H, "cpu"),
                                 waves=2)
        rs = np.random.RandomState(len(name))
        q[6:9] = torch.from_numpy(rs.uniform(0.05, 1.0, (3, q.shape[1]))
                                  .astype(np.float32))
        q[9:12] = torch.from_numpy(rs.uniform(0.0, 0.3, (3, q.shape[1]))
                                   .astype(np.float32))
        hit = ttrace.intersect_scene(scene, V3(q[0], q[1], q[2]),
                                     V3(q[3], q[4], q[5]))
        assert 0.3 < float((hit.tri >= 0).float().mean()) < 1.0
        _CACHE[name] = (scene, q, q_id, hit)
    return _CACHE[name]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit as values (NaN equal to NaN)."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def _same_dirs(a: torch.Tensor, b: torch.Tensor,
               refracted: torch.Tensor) -> bool:
    """Directions [3, n]: bit-equal, except the lanes that may have
    refracted off a dielectric, within SQRT_ATOL."""
    return (_same(a[:, ~refracted], b[:, ~refracted])
            and bool(((a[:, refracted] - b[:, refracted]).abs()
                      <= SQRT_ATOL).all()))


def _dielectric(scene, hit) -> torch.Tensor:
    """The hit lanes on a dielectric material."""
    mtype = ttrace.shade_lanes(scene, hit)[3].mtype
    return (hit.tri >= 0) & (mtype == 2)


def _host(name: str, *argtypes):
    fn = getattr(kernels.load_host_library(), f"srt_{name}_host")
    fn.argtypes = list(argtypes)
    fn.restype = None
    return fn


def _rows(v: V3) -> torch.Tensor:
    return torch.stack(list(v)).contiguous()


def _wild(hit: Hit) -> Hit:
    """Every 7th hit lane gets barycentrics far outside the triangle, so
    that the texel coordinates saturate and wrap from below."""
    u, v = hit.u.clone(), hit.v.clone()
    k = torch.arange(u.shape[0])
    far = (k % 7 == 0) & (hit.tri >= 0)
    u[far] = torch.where(k[far] % 2 == 0, 3.0e7, -2.5e7)
    v[far] = -0.5 * u[far]
    return hit._replace(u=u, v=v)


def _check_draws(_scene_name, _rr):
    rs = np.random.RandomState(2)
    a = torch.from_numpy(rs.randint(0, 2**32, 4096, dtype=np.int64))
    b = torch.from_numpy(rs.randint(0, 2**32, 4096, dtype=np.int64))
    a[:2], b[:2] = torch.tensor([0, 2**32 - 1]), torch.tensor([0, 2**32 - 1])
    n = a.shape[0]
    key, uni = torch.empty(n, dtype=torch.int64), torch.empty(n)
    uni3, ruv = torch.empty(3, n), torch.empty(3, n)
    _host("draws", _P, _P, ctypes.c_int64, _P, _P, _P, _P)(
        a.data_ptr(), b.data_ptr(), n, key.data_ptr(), uni.data_ptr(),
        uni3.data_ptr(), ruv.data_ptr())
    assert torch.equal(key, trng.make_key(a, b))
    assert torch.equal(uni, trng.uniform(a, b))
    assert torch.equal(uni3, torch.stack(trng.uniform3(a, b)))
    assert torch.equal(ruv, _rows(random_unit_vector(a, b)))


def _plain_rec(scene, hit):
    """The plain stages' shading inputs as the kernel's record rows."""
    normal, uu, vv, mat = ttrace.shade_lanes(scene, hit)
    albedo = tmats.albedo_lanes(scene, mat, uu, vv)
    return torch.stack([*normal, *albedo, *mat.emissive,
                        mat.mtype.to(torch.float32), mat.rough, mat.ior])


def _check_shade(scene_name, _rr):
    scene, _, _, hit = _scene(scene_name)
    hit = _wild(hit)
    rec = vertex.shade(scene, hit)
    ok = hit.tri >= 0
    assert _same(rec[:, ok], _plain_rec(scene, hit)[:, ok])
    kinds = set(rec[9, ok].tolist())
    assert kinds <= {0.0, 1.0, 2.0} and len(kinds) >= 2
    if scene.has_textures:
        assert bool((ttrace.shade_lanes(scene, hit)[3].tex[ok] >= 0).any())


def _check_scatter(scene_name, _rr):
    scene, q, _, hit = _scene(scene_name)
    n = hit.t.shape[0]
    normal, uu, vv, mat = ttrace.shade_lanes(scene, hit)
    d_unit = normalize(V3(q[3], q[4], q[5]), eps=1e-20)
    key = trng.make_key(5, torch.arange(n))
    cont, new_dir, att = tmats.scatter(scene, mat, d_unit, normal, uu, vv,
                                       key, 7)
    rec = vertex.shade(scene, hit)
    hcont = torch.empty(n, dtype=torch.bool)
    hdir, hatt = torch.empty(3, n), torch.empty(3, n)
    _host("scatter_lane", _P, _P, _P, ctypes.c_uint32, ctypes.c_int64, _P,
          _P, _P)(rec.data_ptr(), _rows(d_unit).data_ptr(), key.data_ptr(),
                  7, n, hcont.data_ptr(), hdir.data_ptr(), hatt.data_ptr())
    ok = hit.tri >= 0
    assert torch.equal(hcont[ok], cont[ok])
    assert _same_dirs(hdir[:, ok], _rows(new_dir)[:, ok],
                      _dielectric(scene, hit)[ok])
    assert _same(hatt[:, ok], _rows(att)[:, ok])
    assert 0.0 < float(cont[ok].float().mean()) <= 1.0


def _check_roulette(_scene_name, _rr):
    rs = np.random.RandomState(4)
    att = torch.from_numpy(rs.uniform(0.0, 1.2, (3, 4096)).astype(np.float32))
    key = trng.make_key(9, torch.arange(4096))
    survive, scaled = ttrace.rr_survive(V3(*att), key, 6)
    hatt, hsurv = att.clone(), torch.empty(4096, dtype=torch.bool)
    _host("roulette", _P, _P, ctypes.c_uint32, ctypes.c_int64, _P)(
        hatt.data_ptr(), key.data_ptr(), 6, 4096, hsurv.data_ptr())
    assert torch.equal(hsurv, survive)
    assert 0.2 < float(survive.float().mean()) < 0.9
    assert _same(hatt[:, survive], _rows(scaled)[:, survive])
    assert torch.equal(hatt[:, ~survive], att[:, ~survive])


def _path_state(scene_name):
    """A megakernel state over the scene's queue with about 30 % of the
    lanes done, their hits masked as an intersect with active = live
    reports them; each column a tensor of its own."""
    scene, q, q_id, hit = _scene(scene_name)
    n = q.shape[1]
    rs = np.random.RandomState(7)
    done = torch.from_numpy(rs.rand(n) < 0.3)
    res = torch.from_numpy(rs.uniform(0.0, 0.5, (3, n)).astype(np.float32))
    st = ttrace.PathState(o=V3(*q[0:3]), d=V3(*q[3:6]), att=V3(*q[6:9]),
                          rad=V3(*q[9:12]), result=V3(*res), done=done)
    hit = Hit(t=torch.where(done, 0.0, hit.t),
              tri=torch.where(done, -1, hit.tri).to(hit.tri.dtype),
              u=torch.where(done, 0.0, hit.u),
              v=torch.where(done, 0.0, hit.v))
    key = trng.make_key(trng.make_key(SEED, q_id // (W * H)), q_id % (W * H))
    return scene, st, hit, key


def _copy_state(st):
    return ttrace.PathState(*(V3(*(c.clone() for c in v)) for v in st[:5]),
                            done=st.done.clone())


# bounces 1 and 4 (counters 3 and 6): russian roulette starts at
# bounce RR_START = 3
_BOUNCES = (1, 4)


def _check_trace_step(scene_name, rr, monkeypatch):
    scene, st, hit, key = _path_state(scene_name)
    monkeypatch.setattr(ttrace, "intersect_scene",
                        lambda scene, o, d, active=None, ordered=False: hit)
    for counter in (b + 2 for b in _BOUNCES):
        plain = ttrace.trace_step(scene, st, key, counter, rr=rr)
        mine = _copy_state(st)
        out = ttrace.step_by_hand(scene, mine, hit, hit.tri < 0, key,
                                  counter, rr=rr)
        assert out is mine
        for name, a, b in zip(plain._fields, plain[:5], mine[:5]):
            if name == "d":
                assert _same_dirs(_rows(a), _rows(b),
                                  _dielectric(scene, hit))
            else:
                assert _same(_rows(a), _rows(b)), name
        assert torch.equal(plain.done, mine.done)
        newly = mine.done & ~st.done
        assert 0 < int(newly.sum()) < int((~st.done).sum())
        if rr and counter - 2 >= ttrace.RR_START:  # roulette ended paths
            assert int(newly.sum()) > int((ttrace.trace_step(
                scene, st, key, counter).done & ~st.done).sum())


def _check_bounce(scene_name, rr, monkeypatch):
    """One whole _bounce: the plain stages against _stages_by_hand run
    on the host build, the same compacted queue and pixel sums."""
    scene, q, q_id, hit = _scene(scene_name)
    monkeypatch.setattr(ttrace, "intersect_scene",
                        lambda scene, o, d, active=None: hit)
    lane = torch.arange(W * H, dtype=torch.int64) * 7 + 11
    plain_stages = twf._stages_plain
    for bounce in _BOUNCES:
        out = []
        for stages in (plain_stages, twf._stages_by_hand):
            monkeypatch.setattr(twf, "_stages_plain", stages)
            acc = torch.zeros((W * H, 3))
            q2, q_id2 = twf._bounce(scene, q, q_id, bounce, acc, SEED,
                                    SAMPLE_OFFSET, lane, rr=rr)
            out.append((q2, q_id2, acc))
        (q2, id2, acc), (hq2, hid2, hacc) = out
        assert torch.equal(id2, hid2)
        assert 0 < id2.numel() < q_id.numel()
        rows = torch.tensor([r not in (3, 4, 5) for r in range(12)])
        assert _same(q2[rows], hq2[rows])
        # q_id is 0..N-1, so the survivors' lanes are their ids
        assert _same_dirs(q2[3:6], hq2[3:6], _dielectric(scene, hit)[id2])
        assert _same(acc, hacc) and float(acc.abs().sum()) > 0


_CHECKS = {"draws": _check_draws, "shade": _check_shade,
           "scatter": _check_scatter, "roulette": _check_roulette,
           "trace_step": _check_trace_step, "bounce": _check_bounce}
_CASES = ([("draws", None, False), ("roulette", None, True)]
          + [(s, sc, False) for s in ("shade", "scatter") for sc in _SCENES]
          + [(s, sc, rr) for s in ("trace_step", "bounce") for sc in _SCENES
             for rr in (False, True)])


@pytest.mark.parametrize("stage,scene,rr", _CASES)
def test_host_build_matches_plain_stages(stage, scene, rr, monkeypatch):
    fn = _CHECKS[stage]
    if stage in ("trace_step", "bounce"):
        fn(scene, rr, monkeypatch)
    else:
        fn(scene, rr)
