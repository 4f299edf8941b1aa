"""Full reference-workload frame times — the reference's OWN headline
settings (it publishes no numbers; run this on the card for ours):

  variant B (RTrace/raytrace.metal:24-25):   800x600, 400 spp, 3 bounces
  variant A (shaders.metal:644-649):         800x600, 6 camera rays,
                                             300 MIS samples

Times forward-only and differentiable fwd+bwd for each, with the
chained-scan methodology. Variant B's fwd+bwd auto-selects records_only
(the draw planes at 400 spp would be ~9 GB). Run:
python benchmarks/bench_reference.py
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    sys.path.insert(0, ".")
    from gpuraytracer_tpu.intersect import potential_occluders
    from gpuraytracer_tpu.ops.pallas_mis import render_mis_pallas
    from gpuraytracer_tpu.ops.pallas_mis_bwd import render_mis_fused
    from gpuraytracer_tpu.ops.pallas_path import _render_pallas_impl
    from gpuraytracer_tpu.ops.pallas_shade import render_path_decoupled_fused
    from gpuraytracer_tpu.scene import cornell_box
    from gpuraytracer_tpu.types import RenderConfig
    from gpuraytracer_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    W, H = 800, 600
    scene = jax.device_put(cornell_box(resolution=(W, H)))

    cfg_b = RenderConfig(width=W, height=H, integrator="path", spp=400,
                         bounces=3)
    cfg_a = RenderConfig(width=W, height=H, integrator="mis", camera_rays=6,
                         mis_samples=300)
    occ_b = potential_occluders(scene, cfg_b)
    occ_a = potential_occluders(scene, cfg_a)
    rays_b = W * H * 400 * 3 * 2
    rays_a = W * H * 6 * (1 + 100 * 5)

    jobs = [
        ("variant B fwd       (400spp/3b)", rays_b, 2,
         lambda s: jnp.mean(_render_pallas_impl(s, cfg_b,
                                                occluders=occ_b))),
        ("variant B fwd+bwd   (400spp/3b)", rays_b, 2, None),  # below
        ("variant A fwd       (6x300 MIS)", rays_a, 2,
         lambda s: jnp.mean(render_mis_pallas(s, cfg_a))),
        ("variant A fwd+bwd   (6x300 MIS)", rays_a, 2, None),
    ]

    def vb_pair(s):
        return jnp.mean(render_path_decoupled_fused(s, cfg_b,
                                                    occluders=occ_b))

    def va_pair(s):
        return jnp.mean(render_mis_fused(s, cfg_a, occluders=occ_a))

    jobs[1] = (jobs[1][0], rays_b, 2, ("grad", vb_pair))
    jobs[3] = (jobs[3][0], rays_a, 2, ("grad", va_pair))

    for name, rays, iters, fn in jobs:
        if isinstance(fn, tuple):
            vg = jax.value_and_grad(fn[1], allow_int=True)

            def step(s, eps):
                light = dataclasses.replace(
                    s.light, color=s.light.color * (1.0 + eps),
                    emitted_radiance=s.light.emitted_radiance * (1.0 + eps))
                l, g = vg(dataclasses.replace(s, light=light))
                gsum = sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(g)
                           if hasattr(x, "dtype") and x.dtype == jnp.float32)
                return l + 0.0 * gsum
        else:
            def step(s, eps):
                light = dataclasses.replace(
                    s.light, color=s.light.color * (1.0 + eps),
                    emitted_radiance=s.light.emitted_radiance * (1.0 + eps))
                return fn(dataclasses.replace(s, light=light))

        @jax.jit
        def chain(s, l0):
            def body(l, _):
                return step(s, l * 1e-7), None
            l, _ = jax.lax.scan(body, l0, None, length=iters)
            return l

        l0 = jnp.float32(0.0)
        float(chain(scene, l0))
        dt = min(_t(lambda: float(chain(scene, l0))) for _ in range(3)) / iters
        print(f"{name}: {dt*1e3:7.1f} ms/frame  {rays/dt/1e6:7.0f} Mrays/s",
              flush=True)


if __name__ == "__main__":
    main()
