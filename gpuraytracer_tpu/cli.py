"""CLI driver — renders a scene to PNG with wall-clock timing.

Reference: process entries RTrace/main.swift:13-30 and
Sources/gpuRaytracer/main.swift:13-91 (positional output-filename arg, render,
PNG save, "Render completed in %.2f seconds" print). Everything the reference
hardcodes is a flag here (SURVEY.md §5 config plan).
"""
from __future__ import annotations

import argparse
import time



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpuraytracer-tpu",
        description="Differentiable path tracer",
    )
    p.add_argument("output", nargs="?", default="output.png",
                   help="output PNG filename (positional, like the reference)")
    p.add_argument("--integrator",
                   choices=["path", "mis", "direct", "legacy"],
                   default="path")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=400)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--camera-rays", type=int, default=6)
    p.add_argument("--mis-samples", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene",
                   choices=["cornell", "cornell-spheres", "legacy-sphere",
                            "legacy-box", "legacy-square"],
                   default="cornell")
    p.add_argument("--exposure", type=float, default=2.0,
                   help="variant-B CPU tonemap exposure (image.swift:41)")
    p.add_argument("--debug-output", default=None,
                   help="write row-averaged HDR stats (debugOutput.txt analog)")
    p.add_argument("--kernel", choices=["jnp", "pallas", "decoupled"],
                   default="jnp",
                   help="reference jnp path, the Pallas trace kernel, or "
                        "the differentiable kernel pair (trace + backward)")
    p.add_argument("--debug-nans", action="store_true",
                   help="abort with a traceback on the first NaN-producing "
                        "op (utils.debug; forces sync execution — slow)")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the render over the first N jax devices "
                        "(pixels sharded, scene replicated, fused kernels; "
                        "requires --kernel decoupled; any integrator). "
                        "Default 1 = single-device.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    if args.debug_nans:
        from .utils import debug
        debug.enable(nans=True)
    from . import image as img
    from .render import render_jit, tonemap_mis
    from .scene import cornell_box, cornell_box_with_spheres
    from .types import RenderConfig
    from .utils.host import fetch

    config = RenderConfig(
        width=args.width, height=args.height, integrator=args.integrator,
        spp=args.spp, bounces=args.bounces, camera_rays=args.camera_rays,
        mis_samples=args.mis_samples, seed=args.seed,
    )
    if args.scene == "cornell":
        scene = cornell_box(resolution=(args.width, args.height))
    elif args.scene == "cornell-spheres":
        scene = cornell_box_with_spheres(resolution=(args.width, args.height))
    else:
        from .scene import legacy_cornell
        scene = legacy_cornell(args.scene.split("-", 1)[1],
                               resolution=(args.width, args.height))

    if args.integrator == "legacy" and args.kernel != "jnp":
        raise SystemExit("--integrator legacy supports --kernel jnp only")
    if args.devices > 1 and not (
            args.kernel == "decoupled"
            and args.integrator in ("path", "direct", "mis")):
        raise SystemExit("--devices N>1 requires --kernel decoupled "
                         "(path/direct/mis — the fused sharded paths)")
    if args.devices > len(jax.devices()):
        raise SystemExit(f"--devices {args.devices} > available "
                         f"{len(jax.devices())} jax devices")

    start = time.perf_counter()
    if args.devices > 1:
        # Several devices: pixels sharded over a 1-D ``rays`` mesh, scene
        # replicated, fused trace kernel per shard (parallel/fast.py). The
        # sharded image is bit-identical per pixel to the single-device one
        # (RNG is a pure function of the global pixel id).
        from .parallel.mesh import make_ray_mesh
        mesh = make_ray_mesh(jax.devices()[:args.devices])
        if args.integrator == "mis":
            from .parallel.fast import render_mis_fused_sharded
            acc = jax.block_until_ready(
                render_mis_fused_sharded(scene, config, mesh))
            hdr, out = acc, tonemap_mis(acc, config.camera_rays,
                                        scene.camera.ev100)
        else:
            from .parallel.fast import render_path_fused_sharded
            cfg = (config.replace(bounces=1)
                   if args.integrator == "direct" else config)
            hdr = jax.block_until_ready(
                render_path_fused_sharded(scene, cfg, mesh))
            out = None
    elif args.kernel == "pallas":
        if args.integrator == "mis":
            from .ops import render_mis_pallas
            acc = jax.block_until_ready(render_mis_pallas(scene, config))
            hdr, out = acc, tonemap_mis(acc, config.camera_rays,
                                        scene.camera.ev100)
        else:
            from .ops import render_path_pallas
            cfg = (config.replace(bounces=1)
                   if args.integrator == "direct" else config)
            hdr = jax.block_until_ready(render_path_pallas(scene, cfg))
            out = None
    elif args.kernel == "decoupled":
        # Static shadow-probe culling — scene is concrete here; decisions
        # are bit-identical to the full loop (intersect.potential_occluders).
        from .intersect import potential_occluders
        occ = potential_occluders(scene, config)
        if args.integrator == "mis":
            # Fused MIS: trace-kernel forward + record-replay backward
            # kernel (the repo's fastest differentiable variant-A path).
            from .ops.pallas_mis_bwd import render_mis_decoupled
            acc = jax.block_until_ready(
                render_mis_decoupled(scene, config, occluders=occ))
            hdr, out = acc, tonemap_mis(acc, config.camera_rays,
                                        scene.camera.ev100)
        else:
            from .ops import render_path_decoupled
            cfg = (config.replace(bounces=1)
                   if args.integrator == "direct" else config)
            hdr = jax.block_until_ready(
                render_path_decoupled(scene, cfg, occluders=occ))
            out = None
    else:
        result = jax.block_until_ready(render_jit(scene, config))
        hdr, out = result.hdr, result.ldr
    elapsed = time.perf_counter() - start

    hdr_np = fetch(hdr)
    if out is not None:  # mis integrator tonemaps in-graph
        img.write_png(args.output, img.to_uint8(fetch(out)))
    else:
        img.write_png(args.output, img.tonemap(hdr_np, exposure=args.exposure))
    if args.debug_output:
        img.write_debug_file(args.debug_output, hdr_np)

    # Timing print (Sources/gpuRaytracer/main.swift:87-91).
    print(f"Render completed in {elapsed:.2f} seconds")
    print(f"Image saved to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
