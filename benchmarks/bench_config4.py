"""BASELINE config-4 step time.

Times the inverse-rendering optimizer step (render + pixel loss + backward
+ optax update) through the three estimators:

  * oracle    — jnp renderer AD (`pixel_loss`)
  * fast      — trace kernel + hand-written backward kernel
                (`fast_pixel_loss`, draws + occluders hoisted)
  * soft      — the edge-aware jnp renderer (`soft_pixel_loss`,
                sphere-center recovery estimator, grad/diff_render.py)

Workload: cornell_box_with_spheres at 256^2; path spp4/bounce2 for the
interior estimators, direct spp4 for the silhouette estimator (its scope).
Timing: one persistent jitted 500-step lax.scan per estimator, min over
5 calls of the same executable (calling inverse_render per trial would
re-trace its closure each time).
"""
import sys
import time

sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0])

import jax
import jax.numpy as jnp

from gpuraytracer_tpu.grad.inverse import (SceneParams, extract_params,
                                           inverse_render, render_hdr)
from gpuraytracer_tpu.scene import cornell_box_with_spheres
from gpuraytracer_tpu.types import RenderConfig
from gpuraytracer_tpu.utils.cache import enable_compilation_cache

STEPS_LONG = 500


def main():
    enable_compilation_cache()
    scene = jax.device_put(cornell_box_with_spheres(resolution=(256, 256)))
    true_params = extract_params(scene)

    runs = [
        ("oracle(path spp4/b2)", dict(integrator="path", spp=4, bounces=2),
         dict()),
        ("fast(path spp4/b2)", dict(integrator="path", spp=4, bounces=2),
         dict(fast=True)),
        ("fast, no hoist", dict(integrator="path", spp=4, bounces=2),
         dict(fast=True, hoist=False)),
        ("soft(direct spp4)", dict(integrator="direct", spp=4, bounces=1),
         dict(soft=True, kappa=0.1)),
    ]
    for name, cfg_kw, inv_kw in runs:
        cfg = RenderConfig(width=256, height=256, pixel_chunk=65536,
                           **cfg_kw)
        target = jax.block_until_ready(render_hdr(scene, cfg))
        init = SceneParams(
            sphere_centers=true_params.sphere_centers + 0.05,
            sphere_diffuse=true_params.sphere_diffuse * 0.8,
            light_emission=true_params.light_emission * 1.2)

        # One persistent jitted N-step loop per estimator (inverse_render
        # re-traces per call): build the same optax scan once, call it
        # repeatedly, take the min.
        import optax
        from functools import partial as _partial

        from gpuraytracer_tpu.grad.inverse import (fast_pixel_loss,
                                                   pixel_loss,
                                                   soft_pixel_loss)
        if inv_kw.get("soft"):
            loss_fn = _partial(soft_pixel_loss, kappa=inv_kw["kappa"])
        elif inv_kw.get("fast"):
            if inv_kw.get("hoist", True):
                from gpuraytracer_tpu.intersect import potential_occluders
                from gpuraytracer_tpu.ops.pallas_path import pregen_draws
                loss_fn = _partial(
                    fast_pixel_loss, draws=pregen_draws(cfg),
                    occluders=potential_occluders(scene, cfg,
                                                  sphere_slack=0.5))
            else:
                loss_fn = fast_pixel_loss
        else:
            loss_fn = pixel_loss
        opt = optax.adam(1e-2)

        @jax.jit
        def run_loop(params, target):
            opt_state = opt.init(params)

            def step(carry, _):
                p, s = carry
                loss, g = jax.value_and_grad(loss_fn)(p, scene, cfg, target)
                up, s = opt.update(g, s, p)
                return (optax.apply_updates(p, up), s), loss

            (_, _), losses = jax.lax.scan(step, (params, opt_state), None,
                                          length=STEPS_LONG)
            return losses

        t0 = time.perf_counter()
        losses = jax.block_until_ready(run_loop(init, target))
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(run_loop(init, target))
            ts.append(time.perf_counter() - t0)
        step_ms = min(ts) / STEPS_LONG * 1e3
        print(f"{name:24s} compile {compile_s:6.1f}s  "
              f"{step_ms:8.2f} ms/step  (final loss {float(losses[-1]):.3e})",
              flush=True)


if __name__ == "__main__":
    main()
