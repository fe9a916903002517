"""Shared helpers for the tests that hold the PyTorch port against the
JAX package: the same numpy inputs go to both, results come back as
numpy."""

import numpy as np
import torch

from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.utils.gltf import load_glb

torch.set_num_threads(2)


def tv3(a: np.ndarray) -> V3:
    """[R, 3] numpy -> port V3 of contiguous [R] tensors."""
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i],
                                                      np.float32))
                for i in range(3)))


def jv3(a: np.ndarray):
    """[R, 3] numpy -> JAX V3."""
    import jax.numpy as jnp

    from sycl_ray_tracer_tpu.ops.vec import V3 as JV3
    return JV3(*(jnp.asarray(np.ascontiguousarray(a[:, i], np.float32))
                 for i in range(3)))


def np3(v) -> np.ndarray:
    """Either package's V3 -> [R, 3] numpy."""
    return np.stack([np.asarray(c) for c in v], axis=-1)


def pinned_rays(scene, cam):
    """2,048 primary and 2,048 first-bounce rays of a 64x32 frame of
    `cam` (seed 0), as [6, 2048] CPU tensors (o then d): the primaries
    of one sample per pixel, and the first 2,048 survivors, in queue
    order, of a bounce over two samples per pixel on `scene`."""
    from sycl_ray_tracer_torch.models.wavefront import (_bounce, _gen_queue,
                                                        frame_pixels)

    pixels = frame_pixels(64, 32, "cpu")
    q, _ = _gen_queue(cam, 0, 0, pixels=pixels)
    q2, q2_id = _gen_queue(cam, 0, 0, pixels=pixels, waves=2)
    qb, _ = _bounce(scene, q2, q2_id, 0, torch.zeros((64 * 32, 3)), 0, 0,
                    pixels[2])
    return {"primary": q[0:6, :2048].contiguous(),
            "bounce": qb[0:6, :2048].contiguous()}


def lane_mask(kind: str, r: int, seed: int) -> torch.Tensor:
    """An active mask of r lanes: "none", "one" (lane r // 3 alone),
    "sparse" (about 45 % at random, seeded) or "all"."""
    if kind == "none":
        return torch.zeros(r, dtype=torch.bool)
    if kind == "one":
        return torch.arange(r) == r // 3
    if kind == "sparse":
        return torch.from_numpy(np.random.RandomState(seed).rand(r) < 0.45)
    return torch.ones(r, dtype=torch.bool)


def host_vs_plain(host, plain) -> None:
    """The host build of a kernel's walk against its plain version on
    the same rays: hit/miss equal, ids equal outside equal-t ties (1e-6
    relative: the two walk in another order), and t, u, v equal bit for
    bit wherever the ids agree (inactive and miss lanes included)."""
    assert torch.equal(host.tri >= 0, plain.tri >= 0)
    tie = (host.t - plain.t).abs() <= 1e-6 * plain.t.abs()
    same = host.tri == plain.tri
    assert not (~same & ~tie).any()
    for a, b in ((host.t, plain.t), (host.u, plain.u), (host.v, plain.v)):
        assert torch.equal(a[same], b[same])


def port_pair(glb: bytes, width: int = 64, height: int = 64):
    """(HostScene, DeviceScene, Camera) of the port, on the CPU."""
    host = load_glb(glb)
    scene = build_device_scene(host, device="cpu")
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device="cpu")
    return host, scene, cam
