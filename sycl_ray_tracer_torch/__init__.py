"""sycl_ray_tracer_torch — the path tracer of sycl_ray_tracer_tpu,
ported to PyTorch with hand-written CUDA kernels for an NVIDIA H100.

The JAX package beside it is the reference: module and function names
match, so each counterpart is easy to find, and the tests hold the port
against it on the same inputs. Importing this package loads no CUDA
code; kernels are compiled with nvcc at their first launch
(ops/traverse8.py).
"""

__version__ = "0.1.0"
