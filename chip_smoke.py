#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU (or four, with --four).

Drives the main path through the entry points a user calls and checks it
against the jnp oracle, in phases, each printed on its own line:

  1. device     platform, device kind, count, JAX version, XLA_FLAGS, the
                card's name and power limit (nvidia-smi), compile cache dir
  2. compile    every executable of phase 3, compiled in parallel threads
                at full width (512^2: variant-B 16 spp x 3 bounces fwd+bwd,
                variant-A 6 camera rays x 300 MIS samples fwd+bwd), each
                with its memory analysis
  3. parity     every kernel against the jnp oracle run in float64 on the
                card, beside the float32 oracle's own distance from it, on
                the 36-triangle Cornell box, the sphere scene and the
                1,002-triangle tessellated box (the mesh's MIS image at 1
                camera ray x 30 samples and its path gradient at 64^2; MIS
                gradients at 64^2 x 1 x 30 against the oracle's AD on the
                host CPU)
  4. cli        ``gpuraytracer_tpu.cli.main`` with --kernel decoupled at the
                reference's defaults (800x600, 400 spp), then
                --integrator mis; the PNG and --debug-output are checked
  5. card tests the ``gpu``-marked tests, in a child process that runs
                before this process touches the card

Run it from the repository root: ``python chip_smoke.py``. ``--four`` runs
only the sharded paths over four cards (1024^2) and their one-card
comparison. Any failed phase exits non-zero; the last line of a passing
run is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HDR_ATOL = 1e-4
HDR_RTOL = 1e-3
HDR_MIN_CLOSE = 0.999     # share of pixels within HDR_ATOL/HDR_RTOL
MEAN_RTOL = 1e-4          # image mean, relative
GRAD_RTOL = 1e-3          # per leaf, relative to the reference leaf's norm
# The parity reference is the jnp oracle run in float64 on the same inputs
# and random draws. Where the float32 oracle is itself further from it than
# the bars above (a gradient leaf whose per-pixel terms cancel, or pixels
# whose hit flips with rounding), a kernel may be F32_SLACK times as far
# from the reference as the float32 oracle is.
F32_SLACK = 2.0
# Pixels per chunk of the float64 oracle. At the default 16,384, XLA's GPU
# backend failed to compile a float64 oracle job on an H100, asking for
# 256 KiB of shared memory where 227 KiB exist; its per-chunk rows shrink
# with the chunk. The image does not depend on the chunk.
F64_PIXEL_CHUNK = 4096


class PhaseError(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def nvidia_smi() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def probe_platform() -> str:
    """The platform JAX picks, asked in a child so this process stays off
    the card until the card-only tests have run."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300)
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


# --------------------------------------------------------------------------
# Comparisons (pure numpy; also exercised by tests/test_chip_smoke.py)
# --------------------------------------------------------------------------

def hdr_parity(kernel: np.ndarray, oracle: np.ndarray) -> dict:
    """Pixel-wise agreement of two [H, W, 3] images. A pixel agrees when
    all three channels are within HDR_ATOL + HDR_RTOL * |oracle|."""
    kernel = np.asarray(kernel, np.float64)
    oracle = np.asarray(oracle, np.float64)
    check(kernel.shape == oracle.shape,
          f"shape {kernel.shape} != oracle {oracle.shape}")
    check(bool(np.all(np.isfinite(kernel))), "non-finite kernel values")
    close = np.all(np.isclose(kernel, oracle, atol=HDR_ATOL, rtol=HDR_RTOL),
                   axis=-1)
    m_k, m_o = kernel.mean(), oracle.mean()
    return {"pixels": int(close.size),
            "outliers": int(close.size - close.sum()),
            "mean_rel": float(abs(m_k - m_o) / max(abs(m_o), 1e-30)),
            "max_abs": float(np.max(np.abs(kernel - oracle)))}


def hdr_limit(pixels: int, f32_stats: dict | None = None) -> int:
    """The most pixels that may disagree: 1 - HDR_MIN_CLOSE of them, or
    F32_SLACK times as many as the float32 oracle's (``f32_stats``)."""
    limit = int((1.0 - HDR_MIN_CLOSE) * pixels)
    if f32_stats is not None:
        limit = max(limit, int(F32_SLACK * f32_stats["outliers"]))
    return limit


def hdr_ok(stats: dict, f32_stats: dict | None = None) -> bool:
    return (stats["outliers"] <= hdr_limit(stats["pixels"], f32_stats)
            and stats["mean_rel"] <= MEAN_RTOL)


def check_finite(tree, what: str) -> None:
    import jax
    for x in jax.tree.leaves(tree):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            check(bool(np.all(np.isfinite(x))), what)


def grad_errors(grads, ref) -> dict:
    """|grads - ref| / |ref| (Frobenius norms) per float leaf of two
    gradient pytrees, keyed by the leaf's path. A leaf that ``ref`` leaves
    at 0 must be 0."""
    import jax
    check_finite(grads, "non-finite gradient")
    errs = {}
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(grads)):
        g, r = np.asarray(g), np.asarray(r)
        if not np.issubdtype(r.dtype, np.floating):
            continue
        g, r = g.astype(np.float64), r.astype(np.float64)
        norm, err = float(np.linalg.norm(r)), float(np.linalg.norm(g - r))
        if norm > 0.0:
            errs[jax.tree_util.keystr(path)] = err / norm
        else:
            check(err == 0.0, "gradient on a leaf the oracle leaves at 0")
    return errs


def grad_parity(kernel_grads, oracle_grads) -> tuple[float, str]:
    """The worst leaf of ``grad_errors`` and its path."""
    errs = grad_errors(kernel_grads, oracle_grads)
    leaf = max(errs, key=errs.get, default="")
    return errs.get(leaf, 0.0), leaf


def grad_check(kernel_grads, f32_grads, f64_grads) -> dict:
    """Each leaf of the kernel's gradient against the float64 oracle's,
    within GRAD_RTOL or F32_SLACK times the float32 oracle's own error on
    that leaf. Returns the leaf nearest its bar, with its numbers."""
    ek = grad_errors(kernel_grads, f64_grads)
    eo = grad_errors(f32_grads, f64_grads)
    bar = {k: max(GRAD_RTOL, F32_SLACK * eo[k]) for k in ek}
    leaf = max(ek, key=lambda k: ek[k] / bar[k])
    return {"ok": all(ek[k] <= bar[k] for k in ek), "leaf": leaf,
            "rel": ek[leaf], "f32_oracle_rel": eo[leaf], "bar": bar[leaf],
            "max_rel": max(ek.values())}


def check_cli_outputs(png: str, debug: str, width: int, height: int) -> dict:
    """The CLI's PNG and --debug-output: row count equals the height,
    values are finite, the left wall is red and the right wall green."""
    rows = np.loadtxt(debug, ndmin=2)
    check(rows.shape == (height, 3), f"debug rows {rows.shape}")
    check(bool(np.all(np.isfinite(rows))), "non-finite debug rows")
    from gpuraytracer_tpu.image import read_png
    img = read_png(png)[..., :3].astype(np.float64)
    check(img.shape[:2] == (height, width), f"PNG shape {img.shape}")
    mid = img[height // 3:2 * height // 3]
    left = mid[:, : width // 10].mean(axis=(0, 1))
    right = mid[:, -(width // 10):].mean(axis=(0, 1))
    check(left[0] > left[1] and left[0] > left[2], f"left wall {left}")
    check(right[1] > right[0] and right[1] > right[2], f"right wall {right}")
    return {"left_rgb": np.round(left, 1).tolist(),
            "right_rgb": np.round(right, 1).tolist()}


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def _img_and_grads(render):
    """Scene -> (image, d mean(image^2) / d scene), one executable."""
    import jax

    def f(scene):
        img, vjp = jax.vjp(render, scene)
        return img, vjp((2.0 / img.size) * img)[0]
    return f


def compile_all(jobs, threads: int = 8) -> dict:
    """Lower each (name, fn, args) in turn, then compile them in parallel
    threads (XLA's and Triton's compilers release the GIL); prints each
    compile's time and memory analysis. Returns {name: (compiled, args)}."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    def lower(fn, args):
        # Jobs on float64 inputs (the reference oracle) trace with 64-bit
        # types on; the executables keep them when called.
        x64 = any(getattr(x, "dtype", None) == np.float64
                  for x in jax.tree.leaves(args))
        with jax.enable_x64(x64):
            return jax.jit(fn).lower(*args)

    lowered = [(name, lower(fn, args), args) for name, fn, args in jobs]

    def one(item):
        name, low, args = item
        t0 = time.perf_counter()
        compiled = low.compile()
        return name, compiled, args, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as ex:
        done = list(ex.map(one, lowered))
    out = {}
    for name, compiled, args, secs in done:
        mem = str(compiled.memory_analysis()).replace("\n", " ")
        emit("compile", name=name, seconds=f"{secs:.1f}", memory=repr(mem))
        out[name] = (compiled, args)
    emit("compile", total_wall_seconds=f"{time.perf_counter() - t0:.1f}",
         executables=len(out))
    return out


def _scenes(res):
    from gpuraytracer_tpu.scene import (cornell_box, cornell_box_tessellated,
                                        cornell_box_with_spheres)
    return {"box36": cornell_box(resolution=res),
            "spheres": cornell_box_with_spheres(resolution=res),
            "mesh1002": cornell_box_tessellated(resolution=res)}


def phase_device(expect_count: int) -> dict:
    import jax

    from gpuraytracer_tpu.utils.cache import enable_compilation_cache
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    check(info["platform"] == "gpu", f"platform {info['platform']}")
    check(info["count"] >= expect_count,
          f"{info['count']} devices, need {expect_count}")
    emit("device", platform=info["platform"], kind=repr(info["kind"]),
         count=info["count"], jax=jax.__version__,
         xla_flags=repr(os.environ.get("XLA_FLAGS", "")),
         cache=enable_compilation_cache())
    return info


def _to_f64(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(
        lambda x: (jnp.asarray(x, jnp.float64)
                   if getattr(x, "dtype", None) == np.float32 else x), tree)


def parity_jobs(cfg_path, cfg_mis, scenes, cfg_mis_mesh, cfg_small,
                small_scenes):
    """The compile jobs of the parity phase. Each check has three jobs on
    the same scene: ``{check}_kernel/{scene}``, the kernel pair (trace
    kernel + hand-written backward; image and gradients in one executable),
    and the jnp oracle in float32 (``_o32``) and in float64 (``_o64``, the
    reference). The checks: "path" and "mis" at full width, and "path_g" /
    "mis_g", which compare gradients too, with the configs ``cfg_small``
    maps "path"/"mis" to, on ``small_scenes``. The full-width path check
    compares gradients except on the 1,002-triangle scene, whose oracle AD
    at 512^2 would hold ~50 GB of residuals. Every MIS gradient runs its
    oracle AD on the host CPU: XLA's GPU backend fails to launch one of its
    own fusions in ``render_mis``'s gradient (CUDA_ERROR_INVALID_VALUE)."""
    import jax

    from gpuraytracer_tpu.ops import (render_mis_fused,
                                      render_path_decoupled,
                                      render_path_pallas)
    from gpuraytracer_tpu.render import render_mis, render_path

    cpu = jax.devices("cpu")[0]
    jobs = []
    for name, scene in scenes.items():
        mesh = name == "mesh1002"
        small = small_scenes[name]
        # (check, config, scene, oracle device, gradients compared)
        plan = [("path", cfg_path, scene, None, not mesh)]
        if mesh:
            plan.append(("path_g", cfg_small["path"], small, None, True))
        plan += [("mis", cfg_mis_mesh if mesh else cfg_mis, scene, None,
                  False),
                 ("mis_g", cfg_small["mis"], small, cpu, True)]
        for chk, cfg, sc, dev, grads in plan:
            kernel, oracle = ((render_mis_fused, render_mis)
                              if chk.startswith("mis") else
                              (render_path_decoupled, render_path))
            ofn = (lambda s, c=cfg, f=oracle: f(s, c).hdr)
            if grads:
                ofn = _img_and_grads(ofn)
            jobs.append((f"{chk}_kernel/{name}",
                         _img_and_grads(lambda s, c=cfg, f=kernel: f(s, c)),
                         (sc,)))
            jobs.append((f"{chk}_o32/{name}", ofn, (jax.device_put(sc, dev),)))
            # The float64 oracle runs in chunks of F64_PIXEL_CHUNK pixels.
            o64 = (lambda s, c=cfg.replace(pixel_chunk=F64_PIXEL_CHUNK),
                   f=oracle: f(s, c).hdr)
            with jax.enable_x64(True):
                jobs.append((f"{chk}_o64/{name}",
                             _img_and_grads(o64) if grads else o64,
                             (jax.device_put(_to_f64(sc), dev),)))
    jobs.append(("path_trace/box36",
                 lambda s: render_path_pallas(s, cfg_path),
                 (scenes["box36"],)))
    return jobs


def phase_parity(compiled, reductions) -> None:
    """Each kernel pair against the float64 oracle, beside the float32
    oracle's own distance from it: hdr per pixel (HDR_MIN_CLOSE /
    MEAN_RTOL) and, where compared, every float leaf of the scene gradient
    (GRAD_RTOL), each widened to F32_SLACK times the float32 oracle's
    error where that is larger. The kernel's gradients are checked finite
    everywhere."""
    def run(name):
        exe, args = compiled[name]
        return exe(*args)

    failures = []
    for job in [n for n in compiled if "_kernel/" in n]:
        chk, name = job.split("_kernel/")
        note = repr(reductions.get((chk, name), "none"))
        img, g = run(job)
        check_finite(g, f"non-finite {chk} gradient on {name}")
        o32, o64 = run(f"{chk}_o32/{name}"), run(f"{chk}_o64/{name}")
        grads = isinstance(o64, tuple)
        i32, i64 = (o32[0], o64[0]) if grads else (o32, o64)
        f32 = hdr_parity(i32, i64)
        images = [(chk, img)]
        if job == "path_kernel/box36":
            images.append(("path_trace_no_records", run("path_trace/box36")))
        for what, im in images:
            st = hdr_parity(im, i64)
            emit("parity", check=what, scene=name, reduced=note,
                 outliers=st["outliers"], limit=hdr_limit(st["pixels"], f32),
                 f32_oracle_outliers=f32["outliers"],
                 outliers_vs_f32_oracle=hdr_parity(im, i32)["outliers"],
                 pixels=st["pixels"], mean_rel=f"{st['mean_rel']:.2e}",
                 max_abs=f"{st['max_abs']:.3e}")
            if not hdr_ok(st, f32):
                failures.append((what, name, "hdr"))
        if grads:
            r = grad_check(g, o32[1], o64[1])
            emit("parity", check=chk, scene=name, reduced=note,
                 leaf=repr(r["leaf"]), grad_rel=f"{r['rel']:.3e}",
                 f32_oracle_grad_rel=f"{r['f32_oracle_rel']:.3e}",
                 bar=f"{r['bar']:.3e}", max_grad_rel=f"{r['max_rel']:.3e}",
                 max_vs_f32_oracle=f"{grad_parity(g, o32[1])[0]:.3e}")
            if not r["ok"]:
                failures.append((chk, name, "grad"))
    check(not failures, f"parity failures: {failures}")


def phase_cli(tmp: str) -> None:
    from gpuraytracer_tpu import cli
    for tag, extra in (("path", []), ("mis", ["--integrator", "mis"])):
        png = os.path.join(tmp, f"{tag}.png")
        dbg = os.path.join(tmp, f"{tag}_debug.txt")
        t0 = time.perf_counter()
        rc = cli.main([png, "--kernel", "decoupled", "--debug-output", dbg,
                       *extra])
        check(rc == 0, f"cli {tag} exit {rc}")
        walls = check_cli_outputs(png, dbg, 800, 600)
        emit("cli", integrator=tag, width=800, height=600,
             seconds=f"{time.perf_counter() - t0:.1f}", **walls)


def phase_card_tests() -> None:
    env = dict(os.environ, GPURT_TEST_DEVICE="gpu")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:xdist"],
        capture_output=True, text=True, env=env, timeout=900)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    emit("card_tests", rc=out.returncode, summary=repr(tail),
         seconds=f"{time.perf_counter() - t0:.1f}")
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-8000:] + out.stderr[-4000:])
    check(out.returncode == 0, "gpu-marked tests failed")


def phase_four(n_dev: int, cfg_p, cfg_m) -> None:
    """Sharded fwd+bwd of both kernel pairs (configs ``cfg_p``/``cfg_m``)
    and a few fused training steps over ``n_dev`` cards on the 36-triangle
    Cornell box, each against the same work on one card.
    Per-pixel hdr must be bit-identical (the RNG depends on the global
    pixel id); gradients differ only by the order of the cross-card sum.
    The one-card reference of each training step is the loss of the
    one-card kernel pair at the step's parameters."""
    import jax
    import jax.numpy as jnp
    from gpuraytracer_tpu.grad.inverse import apply_params, extract_params
    from gpuraytracer_tpu.ops import render_mis_fused, render_path_decoupled
    from gpuraytracer_tpu.parallel.fast import (render_mis_fused_sharded,
                                                render_path_fused_sharded)
    from gpuraytracer_tpu.parallel.mesh import make_ray_mesh
    from gpuraytracer_tpu.parallel.train import make_train_step_fused
    from gpuraytracer_tpu.scene import cornell_box

    mesh = make_ray_mesh(jax.devices()[:n_dev])
    res = (cfg_p.width, cfg_p.height)
    scene = cornell_box(resolution=res)
    params0 = extract_params(scene)
    target = jnp.zeros((cfg_p.height, cfg_p.width, 3), jnp.float32)
    init_fn, step_fn = make_train_step_fused(scene, cfg_p, mesh,
                                             learning_rate=1e-2)
    state0 = init_fn(jax.tree.map(lambda x: x * 1.05, params0))
    one = jax.devices()[0]
    jobs = [
        ("path/1card", _img_and_grads(
            lambda s: render_path_decoupled(s, cfg_p)),
         (jax.device_put(scene, one),)),
        ("path/ncards", _img_and_grads(
            lambda s: render_path_fused_sharded(s, cfg_p, mesh)), (scene,)),
        ("mis/1card", _img_and_grads(lambda s: render_mis_fused(s, cfg_m)),
         (jax.device_put(scene, one),)),
        ("mis/ncards", _img_and_grads(
            lambda s: render_mis_fused_sharded(s, cfg_m, mesh)), (scene,)),
        ("train_step/ncards", step_fn, (state0, target)),
    ]
    compiled = compile_all(jobs, threads=len(jobs))
    failures = []
    for pair in ("path", "mis"):
        exe1, args1 = compiled[f"{pair}/1card"]
        exen, argsn = compiled[f"{pair}/ncards"]
        h1, g1 = exe1(*args1)
        hn, gn = exen(*argsn)
        ts = {}
        for tag, exe, args in (("1card", exe1, args1),
                               ("ncards", exen, argsn)):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(exe(*args))
                runs.append(time.perf_counter() - t0)
            ts[tag] = float(np.median(runs))
        identical = bool(np.array_equal(np.asarray(h1), np.asarray(hn)))
        worst, leaf = grad_parity(gn, g1)
        emit("four", pair=pair, devices=n_dev, width=cfg_p.width,
             hdr_bit_identical=identical, worst_grad_leaf_rel=f"{worst:.3e}",
             leaf=repr(leaf),
             fwd_bwd_s_1card=f"{ts['1card']:.4f}",
             fwd_bwd_s_ncards=f"{ts['ncards']:.4f}")
        if not identical or worst > GRAD_RTOL:
            failures.append(pair)

    exe_p1, _ = compiled["path/1card"]
    exe_t, (state, _) = compiled["train_step/ncards"]
    for step in range(3):
        s_k = jax.device_put(apply_params(scene, state.params), one)
        ref = float(jnp.mean(exe_p1(s_k)[0] ** 2))
        state, loss = exe_t(state, target)
        loss = float(loss)
        rel = abs(loss - ref) / max(abs(ref), 1e-30)
        emit("four", train_step=step, loss_ncards=f"{loss:.9e}",
             loss_1card=f"{ref:.9e}", rel=f"{rel:.2e}")
        if not (np.isfinite(loss) and rel <= GRAD_RTOL):
            failures.append(f"train_step_{step}")
    check(not failures, f"four-card failures: {failures}")


def run_one_card(res=(512, 512), small_res=(64, 64),
                 cli: bool = True) -> None:
    """Phases 2-4 at full width (512^2; the CLI at 800x600)."""
    import jax

    from gpuraytracer_tpu.types import RenderConfig
    w, h = res
    cfg_path = RenderConfig(width=w, height=h, integrator="path", spp=16,
                            bounces=3)
    cfg_mis = RenderConfig(width=w, height=h, integrator="mis",
                           camera_rays=6, mis_samples=300)
    # The 1,002-triangle scene's MIS image is checked at 1 camera ray x 30
    # samples: its oracle forward at 6 x 300 alone costs ~30x the box's.
    cfg_mis_mesh = cfg_mis.replace(camera_rays=1, mis_samples=30)
    sw, sh = small_res
    cfg_small = {
        "path": cfg_path.replace(width=sw, height=sh),
        "mis": RenderConfig(width=sw, height=sh, integrator="mis",
                            camera_rays=1, mis_samples=30),
    }
    scenes = _scenes(res)
    small = _scenes(small_res)
    size_cut = f"{w}x{h}->{sw}x{sh}"
    mis_cut = "camera_rays 6->1, mis_samples 300->30"
    reductions = {("mis", "mesh1002"): mis_cut,
                  ("path_g", "mesh1002"): size_cut}
    for n in scenes:
        reductions[("mis_g", n)] = (f"{size_cut}, {mis_cut}, oracle on the "
                                    "host CPU")
    with jax.default_matmul_precision("highest"):
        compiled = compile_all(parity_jobs(cfg_path, cfg_mis, scenes,
                                           cfg_mis_mesh, cfg_small, small))
        phase_parity(compiled, reductions)
    if cli:
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths over four cards")
    args = ap.parse_args(argv)

    if importlib.util.find_spec("gpuraytracer_tpu") is None:
        sys.stderr.write("chip_smoke: the gpuraytracer_tpu package is not "
                         "importable; run from the repository root\n")
        return 2
    platform = probe_platform()
    if platform != "gpu":
        sys.stderr.write(f"chip_smoke: JAX finds no GPU (platform "
                         f"{platform!r}); refusing to run\n")
        return 1
    expect = 4 if args.four else 1
    smi = nvidia_smi()
    emit("device", card=repr(smi))
    try:
        if not args.four:
            phase_card_tests()
        info = phase_device(expect)
        from gpuraytracer_tpu.types import RenderConfig
        if args.four:
            phase_four(expect,
                       RenderConfig(width=1024, height=1024,
                                    integrator="path", spp=16, bounces=3),
                       RenderConfig(width=1024, height=1024,
                                    integrator="mis", camera_rays=6,
                                    mis_samples=300))
        else:
            run_one_card()
    except PhaseError as e:
        sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
