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


def port_pair(glb: bytes, width: int = 64, height: int = 64):
    """(HostScene, DeviceScene, Camera) of the port, on the CPU."""
    host = load_glb(glb)
    scene = build_device_scene(host, device="cpu")
    cam = make_camera(width, height, host.camera_position,
                      host.camera_direction, host.camera_focal_length,
                      device="cpu")
    return host, scene, cam
