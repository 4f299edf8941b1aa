"""High-triangle-count (grouped traversal) benchmark.

Measures the tessellated Cornell scene (~1k triangles, scene.py:
cornell_box_tessellated) through the fused kernel pair at the flagship
workload shape (512^2, 16 spp, 3 bounces), plus compile time.

Chained-scan timing methodology (see bench.py): min over trials of a
data-dependent lax.scan chain, one device program.
"""
import sys
import time

sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0])

import jax
import jax.numpy as jnp

from gpuraytracer_tpu.intersect import potential_occluders
from gpuraytracer_tpu.ops.pallas_path import (_render_pallas_impl,
                                              pregen_draws)
from gpuraytracer_tpu.ops.pallas_shade import render_path_decoupled_fused
from gpuraytracer_tpu.scene import cornell_box_tessellated
from gpuraytracer_tpu.types import RenderConfig
from gpuraytracer_tpu.utils.cache import enable_compilation_cache
from gpuraytracer_tpu.utils.metrics import mrays_per_s

ITERS = 8


def chain_fwd(render_fn, scene):
    import dataclasses

    def step(s, l):
        light = dataclasses.replace(
            s.light, color=s.light.color * (1.0 + l * 1e-12))
        s2 = dataclasses.replace(s, light=light)
        hdr = render_fn(s2)
        return jnp.mean(hdr)

    @jax.jit
    def chain(s, l0):
        def body(l, _):
            return step(s, l), None
        l, _ = jax.lax.scan(body, l0, None, length=ITERS)
        return l
    return chain


def chain_pair(render_fn, scene):
    import dataclasses

    def step(s, l):
        light = dataclasses.replace(
            s.light, color=s.light.color * (1.0 + l * 1e-12))
        s2 = dataclasses.replace(s, light=light)
        loss, g = jax.value_and_grad(
            lambda ss: jnp.mean(render_fn(ss)), allow_int=True)(s2)
        gsum = sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(g)
                   if hasattr(x, "dtype") and x.dtype == jnp.float32)
        return loss + 0.0 * gsum

    @jax.jit
    def chain(s, l0):
        def body(l, _):
            return step(s, l), None
        l, _ = jax.lax.scan(body, l0, None, length=ITERS)
        return l
    return chain


def main_mis():
    """Grouped variant-A MIS tier (round 5): tessellated scene through the
    MIS trace kernel + hand-written backward at 512^2. Usage:
    bench_grouped.py --mis [wall_subdiv] [sphere_subdiv] [mis_samples]."""
    import dataclasses

    from gpuraytracer_tpu.ops.pallas_mis import _render_mis_impl
    from gpuraytracer_tpu.ops.pallas_mis_bwd import render_mis_fused

    enable_compilation_cache()
    args = [a for a in sys.argv[1:] if a != "--mis"]
    wall_subdiv = int(args[0]) if len(args) > 0 else 6
    sphere_subdiv = int(args[1]) if len(args) > 1 else 2
    mis_samples = int(args[2]) if len(args) > 2 else 300
    cfg = RenderConfig(width=512, height=512, integrator="mis",
                       camera_rays=6, mis_samples=mis_samples)
    scene = jax.device_put(cornell_box_tessellated(
        resolution=(512, 512), wall_subdiv=wall_subdiv,
        sphere_subdiv=sphere_subdiv))
    n_tris = scene.triangles.num_triangles
    occ = potential_occluders(scene, cfg)
    print(f"tris={n_tris} shadow={sum(occ)} samples={mis_samples}",
          flush=True)
    l0 = jnp.float32(0.0)
    trav = 512 * 512 * 6 * (1 + (mis_samples // 3) * 5)

    def el(s, l):
        return dataclasses.replace(s, light=dataclasses.replace(
            s.light, emitted_radiance=s.light.emitted_radiance
            * (1.0 + l * 1e-12)))

    @jax.jit
    def fwd(s, l0):
        def body(l, _):
            return jnp.mean(_render_mis_impl(el(s, l), cfg,
                                             occluders=occ)), None
        l, _ = jax.lax.scan(body, l0, None, length=ITERS)
        return l

    @jax.jit
    def pair(s, l0):
        def body(l, _):
            loss, g = jax.value_and_grad(
                lambda ss: jnp.mean(render_mis_fused(ss, cfg,
                                                     occluders=occ)),
                allow_int=True)(el(s, l))
            gsum = sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(g)
                       if hasattr(x, "dtype") and x.dtype == jnp.float32)
            return loss + 0.0 * gsum, None
        l, _ = jax.lax.scan(body, l0, None, length=ITERS)
        return l

    for name, f in (("fwd", fwd), ("fwd+bwd", pair)):
        t0 = time.perf_counter()
        float(f(scene, l0))
        compile_s = time.perf_counter() - t0
        ts = [0.0] * 3
        for i in range(3):
            t0 = time.perf_counter()
            float(f(scene, l0))
            ts[i] = time.perf_counter() - t0
        dt = min(ts) / ITERS
        print(f"mis {name}: compile {compile_s:.1f}s, {dt*1e3:.1f} ms = "
              f"{trav/dt/1e6:.0f} Mrays/s", flush=True)


def main():
    enable_compilation_cache()
    wall_subdiv = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    sphere_subdiv = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    cfg = RenderConfig(width=512, height=512, integrator="path", spp=16,
                       bounces=3, pixel_chunk=65536)
    scene = jax.device_put(cornell_box_tessellated(
        resolution=(512, 512), wall_subdiv=wall_subdiv,
        sphere_subdiv=sphere_subdiv))
    n_tris = scene.triangles.num_triangles
    print(f"tris={n_tris}", flush=True)
    occ = potential_occluders(scene, cfg)
    n_shadow = sum(occ)
    print(f"shadow tris after culling: {n_shadow}", flush=True)
    draws = jax.block_until_ready(
        jax.jit(lambda: pregen_draws(cfg))())

    l0 = jnp.float32(0.0)

    # Forward-only megakernel.
    fwd = chain_fwd(lambda s: _render_pallas_impl(s, cfg, occluders=occ),
                    scene)
    t0 = time.perf_counter()
    float(fwd(scene, l0))
    compile_fwd = time.perf_counter() - t0
    ts = [0.0] * 3
    for i in range(3):
        t0 = time.perf_counter()
        float(fwd(scene, l0))
        ts[i] = time.perf_counter() - t0
    dt_fwd = min(ts) / ITERS
    print(f"fwd: compile {compile_fwd:.1f}s, {dt_fwd*1e3:.1f} ms/frame = "
          f"{mrays_per_s(cfg, dt_fwd):.0f} Mrays/s", flush=True)

    # Fused fwd+bwd pair.
    pair = chain_pair(lambda s: render_path_decoupled_fused(
        s, cfg, draws=draws, occluders=occ), scene)
    t0 = time.perf_counter()
    float(pair(scene, l0))
    compile_pair = time.perf_counter() - t0
    for i in range(3):
        t0 = time.perf_counter()
        float(pair(scene, l0))
        ts[i] = time.perf_counter() - t0
    dt_pair = min(ts) / ITERS
    print(f"fwd+bwd: compile {compile_pair:.1f}s, {dt_pair*1e3:.1f} ms = "
          f"{mrays_per_s(cfg, dt_pair):.0f} Mrays/s", flush=True)


if __name__ == "__main__":
    main_mis() if "--mis" in sys.argv else main()
