"""Scaling-efficiency harness (BASELINE north-star: >=90% rays/s efficiency
1 host -> 4 hosts).

Renders the same global workload on 1..N devices and reports rays/s +
efficiency vs the single-device rate, one JSON line per row. Three modes:

  # the GPUs of this machine, one process driving all of them:
  python benchmarks/scaling.py --platform gpu

  # virtual-device validation sweep (8 CPU devices, kernels interpreted;
  # validates the harness and the sharding, not device throughput):
  python benchmarks/scaling.py --platform cpu --devices 8 --width 128 \
      --height 64 --spp 2

  # 2-process jax.distributed row on the CPU (workers are subprocesses, so
  # this mode never runs on the card: a second process cannot share it):
  python benchmarks/scaling.py --platform cpu --multihost 2 --width 128 \
      --height 64 --spp 2

``--grad`` times the full fwd+bwd step (gradient of mean radiance w.r.t.
the scene, psum'd across shards) instead of the forward render.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--grad", action="store_true",
                    help="time fwd+bwd (sharded gradients) instead of fwd")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="pin the JAX backend (cpu runs the kernels in the "
                         "Pallas interpreter)")
    ap.add_argument("--devices", type=int, default=None,
                    help="virtual CPU device count (with --platform cpu)")
    ap.add_argument("--multihost", type=int, default=0, metavar="N",
                    help="run one N-process jax.distributed row instead of "
                         "the in-process sweep")
    ap.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default="localhost:12421",
                    help=argparse.SUPPRESS)
    return ap


def _pin_platform(args):
    """Must run before any jax backend initialization."""
    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["GPURT_PALLAS_INTERPRET"] = "1"
        if args.multihost or args.worker >= 0:
            os.environ.pop("XLA_FLAGS", None)  # one local device per proc
        else:
            n = args.devices or 8
            flags = os.environ.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    flags + f" --xla_force_host_platform_device_count={n}"
                ).strip()
    import jax
    if args.platform is not None:
        jax.config.update("jax_platforms", args.platform)
    return jax


def _timed_row(jax, args, scene, config, mesh, n, base_rate):
    import jax.numpy as jnp

    from gpuraytracer_tpu.parallel.fast import render_path_fused_sharded

    rays = (args.width * args.height * args.spp * args.bounces * 2
            * (2 if args.grad else 1))

    if args.grad:
        vg = jax.value_and_grad(
            lambda s: jnp.mean(render_path_fused_sharded(s, config, mesh)),
            allow_int=True)

        @jax.jit
        def step(s):
            return vg(s)

        def run():
            jax.block_until_ready(step(scene))
    else:
        @jax.jit
        def step(s):
            return render_path_fused_sharded(s, config, mesh)

        def run():
            jax.block_until_ready(step(scene))

    run()  # compile
    dt = min(_t(run) for _ in range(args.iters))
    rate = rays / dt / 1e6
    return {
        "devices": n,
        "mode": "fwd+bwd" if args.grad else "fwd",
        "ms_per_frame": round(dt * 1e3, 3),
        "mrays_s": rate,
        "efficiency_vs_1": (round(rate / (base_rate * n), 4)
                            if base_rate else 1.0),
    }, rate


def run_sweep(args):
    jax = _pin_platform(args)
    from gpuraytracer_tpu.parallel.mesh import make_ray_mesh
    from gpuraytracer_tpu.scene import cornell_box
    from gpuraytracer_tpu.types import RenderConfig
    from gpuraytracer_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    config = RenderConfig(width=args.width, height=args.height,
                          integrator="path", spp=args.spp,
                          bounces=args.bounces)
    scene = cornell_box(resolution=(args.width, args.height))
    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    base_rate = None
    for n in counts:
        mesh = make_ray_mesh(devices[:n])
        row, rate = _timed_row(jax, args, scene, config, mesh, n, base_rate)
        if base_rate is None:
            base_rate = rate
        print(json.dumps(row), flush=True)


def run_multihost(args):
    """Parent: spawn N worker processes; worker 0 prints the JSON row."""
    procs = []
    for pid in range(args.multihost):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--platform", "cpu", "--worker", str(pid),
               "--coordinator", args.coordinator,
               "--multihost", str(args.multihost),
               "--width", str(args.width), "--height", str(args.height),
               "--spp", str(args.spp), "--bounces", str(args.bounces),
               "--iters", str(args.iters)] + (
                   ["--grad"] if args.grad else [])
        procs.append(subprocess.Popen(cmd, cwd=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    rc = [p.wait(timeout=600) for p in procs]
    if any(rc):
        raise SystemExit(f"multihost workers failed: {rc}")


def run_worker(args):
    jax = _pin_platform(args)
    from gpuraytracer_tpu.parallel.mesh import make_ray_mesh
    from gpuraytracer_tpu.parallel.multihost import init_distributed
    from gpuraytracer_tpu.scene import cornell_box
    from gpuraytracer_tpu.types import RenderConfig

    assert init_distributed(args.coordinator, args.multihost, args.worker)
    config = RenderConfig(width=args.width, height=args.height,
                          integrator="path", spp=args.spp,
                          bounces=args.bounces)
    scene = cornell_box(resolution=(args.width, args.height))
    mesh = make_ray_mesh(jax.devices())  # global cross-process mesh
    row, _ = _timed_row(jax, args, scene, config, mesh,
                        len(jax.devices()), None)
    row["processes"] = jax.process_count()
    if jax.process_index() == 0:
        print(json.dumps(row), flush=True)


def main():
    args = build_parser().parse_args()
    if args.worker >= 0:
        run_worker(args)
    elif args.multihost:
        if args.platform != "cpu":
            raise SystemExit("--multihost spawns worker processes; run it "
                             "with --platform cpu")
        run_multihost(args)
    else:
        sys.path.insert(0, ".")
        run_sweep(args)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
