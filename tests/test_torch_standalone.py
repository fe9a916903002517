"""The port stands alone: it imports no JAX, Flax or JAX package (the
card's machine has none), runs its main path without Pillow (nor has
it), and its CLI keeps the stdout contract. Each check runs in a fresh
interpreter."""

import os
import re
import subprocess
import sys

import pytest

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MAIN_PATH_MODULES = [
    "sycl_ray_tracer_torch",
    "sycl_ray_tracer_torch.utils.cli",
    "sycl_ray_tracer_torch.utils.gltf",
    "sycl_ray_tracer_torch.utils.native_loader",
    "sycl_ray_tracer_torch.utils.procgen",
    "sycl_ray_tracer_torch.utils.fixtures",
    "sycl_ray_tracer_torch.utils.image_io",
    "sycl_ray_tracer_torch.utils.png",
    "sycl_ray_tracer_torch.ops.sah",
    "sycl_ray_tracer_torch.ops.wbvh",
    "sycl_ray_tracer_torch.ops.woop",
    "sycl_ray_tracer_torch.ops.rng",
    "sycl_ray_tracer_torch.ops.traverse8",
    "sycl_ray_tracer_torch.models.scene",
    "sycl_ray_tracer_torch.models.trace",
    "sycl_ray_tracer_torch.models.materials",
    "sycl_ray_tracer_torch.models.wavefront",
]

# refuses every import of PIL, as on a machine without Pillow
_NO_PIL = """
import sys
class _NoPil:
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL refused")
        return None
sys.meta_path.insert(0, _NoPil())
"""


def _run(code: str = None, args=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=_ROOT)
    cmd = [sys.executable] + (["-c", code] if code is not None else args)
    return subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = "import importlib, sys\n"
    for m in _MAIN_PATH_MODULES:
        code += f"importlib.import_module({m!r})\n"
    code += ("bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'sycl_ray_tracer_tpu', 'triton')]\n"
             "assert not bad, bad\n"
             "print('ok')\n")
    p = _run(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_main_path_runs_without_pil(tmp_path):
    out = tmp_path / "img.png"
    code = _NO_PIL + f"""
import numpy as np
from sycl_ray_tracer_torch.utils.procgen import sponza_like_glb
from sycl_ray_tracer_torch.utils.gltf import load_glb
from sycl_ray_tracer_torch.utils.fixtures import textured_scene_glb
from sycl_ray_tracer_torch.models.scene import build_device_scene
from sycl_ray_tracer_torch.models.camera import make_camera
from sycl_ray_tracer_torch.models.wavefront import render_wavefront
from sycl_ray_tracer_torch.utils.image_io import write_png
from sycl_ray_tracer_torch.utils.png import decode_png
glb = sponza_like_glb(scale=1)
host = load_glb(glb)
assert host.textures.any()
assert host.textures.shape == (8, 512, 512, 4)
scene = build_device_scene(host)
cam = make_camera(32, 24, host.camera_position, host.camera_direction,
                  host.camera_focal_length)
img, rays = render_wavefront(scene, cam, width=32, height=24, spp=1,
                             max_depth=3)
write_png({str(out)!r}, img.numpy())
back = decode_png(open({str(out)!r}, "rb").read())
assert back.shape == (24, 32, 4)
assert (back[..., :3] == np.clip(img.numpy() * 255, 0, 255).astype(
    np.uint8)).all()
# a texture that needs resizing says so instead of approximating
try:
    load_glb(textured_scene_glb())
except NotImplementedError as e:
    assert "image 0" in str(e) and "64x64" in str(e), e
else:
    raise AssertionError("resize without Pillow did not raise")
assert "PIL" not in sys.modules
print("ok")
"""
    p = _run(code, timeout=240)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().endswith("ok")


def test_cli_stdout_contract(tmp_path):
    out = tmp_path / "tri.png"
    p = _run(args=["-m", "sycl_ray_tracer_torch", "triangle", "--device",
                   "cpu", "-s", "1", "-d", "2", "--width", "32",
                   "--height", "24", "-o", str(out)])
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("Time measured"))
    assert re.fullmatch(r"Time measured: \d+\.\d{6} seconds", lines[i])
    m = re.fullmatch(r"Total rays: (\d+)", lines[i + 1])
    assert m and int(m.group(1)) >= 32 * 24
    assert re.fullmatch(r"Rays/sec: \d+\.\d\dM", lines[i + 2])
    assert out.stat().st_size > 0


def test_cli_refuses_missing_scene(tmp_path):
    missing = str(tmp_path / "none.glb")
    p = _run(args=["-m", "sycl_ray_tracer_torch", missing, "--device",
                   "cpu", "-s", "1", "-d", "1", "--width", "8",
                   "--height", "8"])
    assert p.returncode != 0 and "scene not found" in p.stderr
    assert "Time measured" not in p.stdout


def test_cli_refuses_missing_cuda_and_megakernel():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p = _run(args=["-m", "sycl_ray_tracer_torch", "triangle", "-s", "1",
                   "-d", "1", "--width", "8", "--height", "8"])
    assert p.returncode != 0 and "CUDA is not available" in p.stderr
    p = _run(args=["-m", "sycl_ray_tracer_torch", "triangle", "-m",
                   "--device", "cpu"])
    assert p.returncode != 0 and "megakernel not yet ported" in p.stderr
