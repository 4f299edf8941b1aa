"""Kernel route choice, the backward kernels' per-program partial sums,
the plain-jnp draw pregeneration, and table padding (ops/route.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from gpuraytracer_tpu import sampling as smp
from gpuraytracer_tpu.ops import pallas_mis as pm
from gpuraytracer_tpu.ops import pallas_path as pp
from gpuraytracer_tpu.ops import route
from gpuraytracer_tpu.ops.decoupled import trace_records
from gpuraytracer_tpu.ops.pallas_mis import render_mis_pallas
from gpuraytracer_tpu.ops.pallas_mis_bwd import render_mis_fused
from gpuraytracer_tpu.ops.pallas_path import render_path_pallas
from gpuraytracer_tpu.ops.pallas_shade import render_path_decoupled_fused
from gpuraytracer_tpu.render import pixel_rng_offsets
from gpuraytracer_tpu.scene import cornell_box, cornell_box_tessellated
from gpuraytracer_tpu.types import RenderConfig

_PATH = RenderConfig(width=16, height=8, integrator="path", spp=1,
                     bounces=2)
_MIS = RenderConfig(width=16, height=8, integrator="mis", camera_rays=1,
                    mis_samples=3)


# --------------------------------------------------------------------------
# Route choice
# --------------------------------------------------------------------------

_ENTRY_POINTS = {
    "path_trace": lambda s: pp._render_pallas_impl(s, _PATH),
    "path_custom_vjp": lambda s: render_path_pallas(s, _PATH),
    "path_pair": lambda s: render_path_decoupled_fused(s, _PATH),
    "path_records": lambda s: trace_records(s, _PATH),
    "mis_trace": lambda s: render_mis_pallas(s, _MIS),
    "mis_pair": lambda s: render_mis_fused(s, _MIS),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_point_refuses_cpu_without_interpret_switch(entry,
                                                          monkeypatch):
    """Off a GPU, no kernel runs unless the interpreter is asked for."""
    monkeypatch.delenv(route.INTERPRET_ENV, raising=False)
    scene = cornell_box(resolution=(16, 8))
    with pytest.raises(RuntimeError, match=route.INTERPRET_ENV):
        _ENTRY_POINTS[entry](scene)


def test_interpret_switch_and_explicit_argument(monkeypatch):
    monkeypatch.setenv(route.INTERPRET_ENV, "1")
    assert route.interpret_mode(None) is True
    monkeypatch.delenv(route.INTERPRET_ENV)
    assert route.interpret_mode(True) is True
    # An explicit False asks for the compiled route (used to lower for
    # CUDA from a CPU-only machine); it is not second-guessed.
    assert route.interpret_mode(False) is False


# --------------------------------------------------------------------------
# Per-program partial sums
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p_total", [40, 300])
def test_accumulate_rows_matches_scatter_add(p_total):
    """route.accumulate_rows over several programs, summed, equals a
    serial scatter-add of the hit lanes — including primitive ranges that
    span several PRIM_CHUNKs."""
    n, progs, n_rows = 64, 3, 2
    rng = np.random.default_rng(p_total)
    pc = rng.integers(0, p_total, (progs, n)).astype(np.int32)
    hit = rng.random((progs, n)) < 0.8
    vals = rng.standard_normal((progs, n_rows, n)).astype(np.float32)
    p_pad = route.padded_prims(p_total)

    def kernel(pc_ref, hit_ref, v_ref, part_ref):
        route.zero_partials(part_ref, n_rows, p_pad)
        route.accumulate_rows(part_ref, pc_ref[...], hit_ref[...] > 0,
                              [v_ref[0, k, :] for k in range(n_rows)],
                              p_total)

    part = pl.pallas_call(
        kernel, grid=(progs,),
        in_specs=[pl.BlockSpec((n,), lambda i: (i,)),
                  pl.BlockSpec((n,), lambda i: (i,)),
                  pl.BlockSpec((1, n_rows, n), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, n_rows, p_pad), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((progs, n_rows, p_pad), jnp.float32),
        backend="triton", interpret=True,
    )(jnp.asarray(pc.reshape(-1)), jnp.asarray(hit.reshape(-1), jnp.int32),
      jnp.asarray(vals))
    got = np.asarray(jnp.sum(part, axis=0))
    want = np.zeros((n_rows, p_pad), np.float64)
    for k in range(n_rows):
        np.add.at(want[k], pc[hit], vals[:, k, :][hit])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _path_grads(scene):
    return jax.grad(lambda s: jnp.mean(render_path_decoupled_fused(
        s, _PATH) ** 2), allow_int=True)(scene)


def _mis_grads(scene):
    return jax.grad(lambda s: jnp.mean(render_mis_fused(s, _MIS) ** 2),
                    allow_int=True)(scene)


def _assert_trees_close(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        y = np.asarray(y)
        if np.issubdtype(y.dtype, np.floating) and y.size:
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-5,
                atol=1e-6 * float(np.abs(np.asarray(y)).max() + 1e-30))


@pytest.mark.parametrize("integrator", ["path", "mis"])
@pytest.mark.parametrize("mesh", [False, True])
def test_partial_cotangents_equal_serial_accumulation(integrator, mesh,
                                                      monkeypatch):
    """Backward cotangents summed from four programs' partials equal one
    program's serial accumulation over the whole image (16x8 = 128 rays),
    for the 36-triangle box and a 132-triangle mesh."""
    scene = (cornell_box_tessellated(resolution=(16, 8), wall_subdiv=3,
                                     sphere_subdiv=0)
             if mesh else cornell_box(resolution=(16, 8)))
    if mesh:
        assert scene.triangles.num_triangles > 8 * pp.GROUP
    module, grads = (pp, _path_grads) if integrator == "path" else (
        pm, _mis_grads)
    monkeypatch.setattr(module, "TILE", 128)
    serial = grads(scene)
    monkeypatch.setattr(module, "TILE", 32)
    _assert_trees_close(grads(scene), serial)


# --------------------------------------------------------------------------
# Draw pregeneration
# --------------------------------------------------------------------------

def test_pregen_draws_match_kernel_regenerated_draws():
    """The plain-jnp draw planes and the kernel's own Halton regeneration
    (records_only) drive the same trace: identical records, and hdr equal
    up to the compiler's rounding of the two fused programs."""
    scene = cornell_box(resolution=(16, 8))
    cfg = _PATH.replace(spp=3, bounces=3)
    hdr_a, aux_a = pp._render_pallas_impl(
        scene, cfg, emit_records=True, raw_records=True,
        draws=pp.pregen_draws(cfg))
    hdr_b, aux_b = pp._render_pallas_impl(
        scene, cfg, emit_records=True, records_only=True)
    np.testing.assert_array_equal(np.asarray(aux_a[0]), np.asarray(aux_b[0]))
    np.testing.assert_allclose(np.asarray(hdr_a), np.asarray(hdr_b),
                               rtol=1e-5, atol=1e-7)


def test_pregen_draws_match_oracle_halton():
    """Pregenerated planes hold the oracle sampler's Halton values (to
    within an ulp: the two programs round ``r + f * digit`` on their own),
    laid out [tile, sample, bounce, TILE]."""
    cfg = _PATH.replace(spp=2, bounces=2)
    nee0, _, cos0, _, jx, _ = pp.pregen_draws(cfg)
    n = cfg.num_pixels
    n_pad = pp.padded_len(n)
    off = np.asarray(pixel_rng_offsets(cfg))
    nee0 = np.asarray(nee0).reshape(-1, cfg.spp, cfg.bounces, pp.TILE)
    cos0 = np.asarray(cos0).reshape(-1, cfg.spp, cfg.bounces, pp.TILE)
    jx = np.asarray(jx).reshape(-1, cfg.spp, pp.TILE)
    assert nee0.shape[0] * pp.TILE == n_pad
    for s in range(cfg.spp):
        ih = jnp.asarray(off + s, jnp.uint32)
        np.testing.assert_array_max_ulp(
            jx[:, s, :].reshape(-1)[:n], np.asarray(smp.halton(ih, 0)), 2)
        for b in range(cfg.bounces):
            np.testing.assert_array_max_ulp(
                nee0[:, s, b, :].reshape(-1)[:n],
                np.asarray(smp.halton(ih, 2 + b * 5)), 2)
            np.testing.assert_array_max_ulp(
                cos0[:, s, b, :].reshape(-1)[:n],
                np.asarray(smp.halton(ih, 2 + b * 5 + 2)), 2)


# --------------------------------------------------------------------------
# Table padding
# --------------------------------------------------------------------------

def test_next_pow2():
    assert [route.next_pow2(n) for n in (1, 2, 3, 12, 36, 64, 65, 1002)] == \
        [1, 2, 4, 16, 64, 64, 128, 1024]


def test_pad_pow2_pads_every_axis_with_zeros():
    x = jnp.arange(19 * 36, dtype=jnp.float32).reshape(19, 36)
    y = np.asarray(route.pad_pow2(x))
    assert y.shape == (32, 64)
    np.testing.assert_array_equal(y[:19, :36], np.asarray(x))
    assert not y[19:].any() and not y[:, 36:].any()
    assert route.pad_pow2(jnp.zeros((1, 12)), multiple=32).shape == (1, 32)


def test_padded_prims_is_whole_chunks():
    for p in (1, 36, 38, 64, 65, 1002):
        q = route.padded_prims(p)
        assert q >= p and q % route.PRIM_CHUNK == 0 and q & (q - 1) == 0
