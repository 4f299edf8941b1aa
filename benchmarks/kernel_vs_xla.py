"""Kernel pairs against what XLA makes of the plain versions, on one GPU.

For each hand-written kernel pair, times fwd+bwd (image and the gradient of
mean(image^2) w.r.t. the whole scene, one executable) at 512^2 against the
plain jnp alternatives compiled by XLA for the same card:

  path   variant B, 16 spp x 3 bounces, 36-triangle Cornell box:
           kernel pair  trace kernel + hand-written backward
           oracle AD    render.render_path + jax.vjp
           replay AD    trace kernel records + ops/decoupled.shade_replay AD
  mis    variant A, 6 camera rays x 300 MIS samples:
           kernel pair  MIS trace kernel + hand-written backward
           oracle fwd   render.render_mis alone (its AD fails inside
                        XLA's GPU backend: CUDA_ERROR_INVALID_VALUE on
                        launching one of XLA's own fusions)
  path-sweep, mis-sweep
         rays per program (TILE) x warps per program for each pair
  tiles  the path pair with the blocked pixel-to-program mapping against
         the linear one, on the 36-triangle box and on the 1,002-triangle
         tessellated box (benchmarks/bench_grouped.py's subdivision)

All executables are compiled first, in parallel threads (compile time is
reported apart); each is then timed as the median of ``--reps`` calls
ended by ``block_until_ready`` after one warm-up call. One JSON line per
measurement. Run on the card: ``python benchmarks/kernel_vs_xla.py path
mis path-sweep mis-sweep tiles``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from gpuraytracer_tpu.ops import pallas_mis as pm  # noqa: E402
from gpuraytracer_tpu.ops import pallas_path as pp  # noqa: E402
from gpuraytracer_tpu.ops import route  # noqa: E402
from gpuraytracer_tpu.types import RenderConfig  # noqa: E402

PATH = RenderConfig(width=512, height=512, integrator="path", spp=16,
                    bounces=3, pixel_chunk=65536)
MIS = RenderConfig(width=512, height=512, integrator="mis", camera_rays=6,
                   mis_samples=300)
PATH_SWEEP = ((64, 4), (128, 4), (256, 4), (128, 2), (128, 8), (256, 8))
MIS_SWEEP = ((64, 4), (128, 4), (256, 4))
_BLOCKED = pp.use_blocked_tiles


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def jobs_path(scene):
    from gpuraytracer_tpu.ops import render_path_decoupled, trace_records
    from gpuraytracer_tpu.ops.decoupled import shade_replay
    from gpuraytracer_tpu.render import render_path

    def replay(s):
        _, aux = trace_records(jax.lax.stop_gradient(s), PATH)
        return shade_replay(s, aux, PATH)

    ig = chip_smoke._img_and_grads
    return [
        ("path kernel pair", ig(lambda s: render_path_decoupled(s, PATH)),
         (scene,)),
        ("path trace kernel + shade_replay AD", ig(replay), (scene,)),
        ("path oracle AD", ig(lambda s: render_path(s, PATH).hdr),
         (scene,)),
    ]


def jobs_mis(scene):
    from gpuraytracer_tpu.ops import render_mis_fused
    from gpuraytracer_tpu.render import render_mis
    ig = chip_smoke._img_and_grads
    return [
        ("mis kernel pair", ig(lambda s: render_mis_fused(s, MIS)),
         (scene,)),
        ("mis oracle forward", lambda s: render_mis(s, MIS).hdr, (scene,)),
    ]


def _under(tile, warps, render, blocked=True):
    """Lowering reads TILE / NUM_WARPS / use_blocked_tiles, so each job is
    lowered under its own setting (compile_all lowers in order)."""
    def fn(s):
        pp.TILE = pm.TILE = tile
        route.NUM_WARPS = warps
        pp.use_blocked_tiles = (_BLOCKED if blocked
                                else (lambda config, sharded: False))
        return chip_smoke._img_and_grads(render)(s)
    return fn


def jobs_path_sweep(scene):
    from gpuraytracer_tpu.ops import render_path_decoupled
    return [(f"path kernel pair tile={t} warps={w}",
             _under(t, w, lambda s: render_path_decoupled(s, PATH)), (scene,))
            for t, w in PATH_SWEEP]


def jobs_mis_sweep(scene):
    from gpuraytracer_tpu.ops import render_mis_fused
    return [(f"mis kernel pair tile={t} warps={w}",
             _under(t, w, lambda s: render_mis_fused(s, MIS)), (scene,))
            for t, w in MIS_SWEEP]


def jobs_tiles(scene):
    from gpuraytracer_tpu.ops import render_path_decoupled
    from gpuraytracer_tpu.scene import cornell_box_tessellated
    mesh = jax.device_put(cornell_box_tessellated(resolution=(512, 512)))
    return [(f"path kernel pair {sname} {'blocked' if b else 'linear'}",
             _under(pp.TILE, route.NUM_WARPS,
                    lambda s: render_path_decoupled(s, PATH), blocked=b),
             (sc,))
            for sname, sc in (("box36", scene), ("mesh1002", mesh))
            for b in (True, False)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="+",
                    choices=["path", "mis", "path-sweep", "mis-sweep",
                             "tiles"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time every job this many times, in turn")
    ap.add_argument("--threads", type=int, default=10)
    args = ap.parse_args()
    from gpuraytracer_tpu.scene import cornell_box
    from gpuraytracer_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    default = (pp.TILE, pm.TILE, route.NUM_WARPS)
    print(json.dumps({"card": card(), "kind": dev.device_kind,
                      "tile": pp.TILE, "warps": route.NUM_WARPS}),
          flush=True)
    scene = jax.device_put(cornell_box(resolution=(512, 512)))
    jobs = []
    for part in args.parts:
        jobs += {"path": jobs_path, "mis": jobs_mis,
                 "path-sweep": jobs_path_sweep, "mis-sweep": jobs_mis_sweep,
                 "tiles": jobs_tiles}[part](scene)
    with jax.default_matmul_precision("highest"):
        compiled = chip_smoke.compile_all(jobs, threads=args.threads)
    pp.TILE, pm.TILE, route.NUM_WARPS = default
    pp.use_blocked_tiles = _BLOCKED
    for rnd in range(args.rounds):
        for name, _, _ in jobs:
            exe, a = compiled[name]
            jax.block_until_ready(exe(*a))
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(exe(*a))
                ts.append(time.perf_counter() - t0)
            print(json.dumps({"name": name, "round": rnd,
                              "median_ms": float(np.median(ts)) * 1e3,
                              "all_ms": [t * 1e3 for t in ts]}), flush=True)


if __name__ == "__main__":
    main()
