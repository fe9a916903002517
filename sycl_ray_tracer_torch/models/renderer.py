"""Renderer registry (render.hpp:11-18 equivalent).

The reference exposes both engines behind `IRenderer::render_frame`;
here both are functions with one signature, registered by name so that
callers (the CLI, chip_smoke.py, tests) select them the same way:

    render(scene, cam, *, width, height, spp, max_depth, seed=0, rr=False)
        -> (gamma-encoded image [H, W, 3] f32 on the scene's device,
            per-bounce ray counts [max_depth] int64 on the CPU)
"""

from __future__ import annotations

from typing import Callable


def get_renderer(name: str) -> Callable:
    from sycl_ray_tracer_torch.models.megakernel import render_megakernel
    from sycl_ray_tracer_torch.models.wavefront import render_wavefront

    table = {"megakernel": render_megakernel,
             "wavefront": render_wavefront}
    if name not in table:
        raise KeyError(f"unknown renderer {name!r}; "
                       f"choices: {sorted(table)}")
    return table[name]
