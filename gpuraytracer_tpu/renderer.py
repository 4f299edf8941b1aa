"""Persistent-state renderer — the variant-B ``Renderer`` class analog.

Reference: /root/reference/RTrace/renderer.swift:29-146. Its ``init()`` does
the one-time work (pipeline compile, scene build, buffer marshalling, accel
build) and ``draw()`` dispatches one frame and saves the PNG. The JAX
equivalents: jit compile (pipeline), scene pytree on device (buffers),
``compile_scene`` inside the jitted fn (accel build), one jit call + PNG save
(draw). The jitted callable is cached on the instance so repeated draws skip
retrace/compile exactly like Metal's persistent pipeline state.

Also exposes ``draw_accumulate`` — progressive rendering across calls via the
sample-accumulator pytree (utils/checkpoint.py), realizing the reference's
commented "temporal accumulation" aspiration (RTrace/sampling.metal:127-128).
"""
from __future__ import annotations

import time
from typing import Optional

import jax

from . import image as img
from .render import render, tonemap_mis
from .scene import cornell_box
from .types import RenderConfig, Scene
from .utils.host import fetch


class Renderer:
    """Holds a scene + config + compiled render fn (renderer.swift:29-113)."""

    def __init__(self, scene: Optional[Scene] = None,
                 config: Optional[RenderConfig] = None,
                 kernel: str = "jnp") -> None:
        self.config = config or RenderConfig(
            width=800, height=600, integrator="path", spp=400, bounces=3)
        self.scene = scene if scene is not None else cornell_box(
            resolution=(self.config.width, self.config.height))
        self.scene = jax.device_put(self.scene)
        self.kernel = kernel
        self._fn = self._build(kernel)
        self.last_hdr = None

    def _build(self, kernel: str):
        config = self.config
        if kernel == "pallas":
            if config.integrator == "mis":
                from .ops import render_mis_pallas
                return jax.jit(lambda s: render_mis_pallas(s, config))
            from .ops import render_path_pallas
            cfg = (config.replace(bounces=1)
                   if config.integrator == "direct" else config)
            return jax.jit(lambda s: render_path_pallas(s, cfg))
        if kernel == "decoupled":
            from .ops import render_path_decoupled
            cfg = (config.replace(bounces=1)
                   if config.integrator == "direct" else config)
            return jax.jit(lambda s: render_path_decoupled(s, cfg))
        return jax.jit(lambda s: render(s, config).hdr)

    def render_hdr(self):
        """One frame of linear radiance [H, W, 3] (blocking, like the
        reference's waitUntilCompleted, renderer.swift:144)."""
        hdr = jax.block_until_ready(self._fn(self.scene))
        self.last_hdr = hdr
        return hdr

    def draw(self, path: str = "output.png", exposure: float = 2.0,
             verbose: bool = True) -> float:
        """Render + tonemap + save PNG (Renderer.draw, renderer.swift:117-146).
        Returns wall-clock seconds."""
        start = time.perf_counter()
        hdr = self.render_hdr()
        elapsed = time.perf_counter() - start
        hdr_np = fetch(hdr)
        if self.config.integrator == "mis":
            ldr = fetch(tonemap_mis(hdr, self.config.camera_rays,
                                    self.scene.camera.ev100))
            img.write_png(path, img.to_uint8(ldr))
        else:
            img.write_png(path, img.tonemap(hdr_np, exposure=exposure))
        if verbose:
            print(f"Render completed in {elapsed:.2f} seconds")
            print(f"Image saved to {path}")
        return elapsed

    def draw_accumulate(self, acc=None, spp_step: Optional[int] = None):
        """Progressive rendering: one more batch of spp folded into a running
        (sum, count) accumulator pytree, rendered through this Renderer's
        selected kernel (so a resumable long render runs at kernel speed).
        Returns (acc, resolved_hdr)."""
        from .utils.checkpoint import accumulate, init_accumulator, resolve
        if acc is None:
            acc = init_accumulator(self.config)
        acc = accumulate(self.scene, self.config, acc,
                         spp_step or self.config.spp, kernel=self.kernel)
        return acc, resolve(acc)
