"""Pallas kernel parity: interpret-mode kernel vs the jnp oracle at fixed
seeds (SURVEY.md §4.2 — every kernel gets an interpret=True CPU run and an
allclose check against the pure-jnp implementation)."""
import jax
import numpy as np
import pytest

from gpuraytracer_tpu.ops import render_path_pallas_interpret
from gpuraytracer_tpu.render import render
from gpuraytracer_tpu.scene import cornell_box
from gpuraytracer_tpu.types import RenderConfig


@pytest.fixture(scope="module")
def scene():
    return cornell_box(resolution=(32, 16))


def _cfg(**kw):
    # Interpret-mode kernel execution is slow (~20 s per spp x bounce unit),
    # so parity configs stay minimal; the GPU path is timed in bench.py.
    base = dict(width=32, height=16, integrator="path", spp=1, bounces=3,
                pixel_chunk=512)
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.smoke
def test_kernel_matches_jnp_oracle(scene):
    cfg = _cfg()
    oracle = np.asarray(render(scene, cfg).hdr)
    kernel = np.asarray(render_path_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=2e-5, rtol=1e-4)


def test_kernel_matches_oracle_one_bounce(scene):
    cfg = _cfg(bounces=1, spp=2)
    oracle = np.asarray(render(scene, cfg).hdr)
    kernel = np.asarray(render_path_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=2e-5, rtol=1e-4)


def test_kernel_nonsquare_non_tile_multiple():
    """Pixel count not divisible by TILE exercises the padding path."""
    scene = cornell_box(resolution=(24, 18))  # 432 px < TILE
    cfg = _cfg(width=24, height=18, spp=1)
    oracle = np.asarray(render(scene, cfg).hdr)
    kernel = np.asarray(render_path_pallas_interpret(scene, cfg))
    assert kernel.shape == (18, 24, 3)
    np.testing.assert_allclose(kernel, oracle, atol=2e-5, rtol=1e-4)


def test_kernel_seed_sensitivity(scene):
    a = np.asarray(render_path_pallas_interpret(scene, _cfg(seed=0, bounces=1)))
    b = np.asarray(render_path_pallas_interpret(scene, _cfg(seed=3, bounces=1)))
    assert not np.array_equal(a, b)


def test_kernel_backward_matches_jnp_grad(scene):
    """The custom VJP (jnp fallback) produces the oracle's gradients."""
    import dataclasses
    import jax.numpy as jnp
    from gpuraytracer_tpu.ops.pallas_path import _render_pallas_impl
    from gpuraytracer_tpu.ops import render_path_pallas

    cfg = _cfg(spp=1, bounces=1)

    def loss_pallas(color):
        light = dataclasses.replace(scene.light, color=color)
        s = dataclasses.replace(scene, light=light)
        return jnp.mean(render_path_pallas(s, cfg))

    def loss_jnp(color):
        light = dataclasses.replace(scene.light, color=color)
        s = dataclasses.replace(scene, light=light)
        return jnp.mean(render(s, cfg).hdr)

    c = jnp.asarray(scene.light.color)
    # Forward runs the (interpreted on CPU) kernel; backward the jnp VJP.
    g_k = np.asarray(jax.grad(loss_pallas)(c))
    g_j = np.asarray(jax.grad(loss_jnp)(c))
    np.testing.assert_allclose(g_k, g_j, atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# Variant-A MIS megakernel (ops/pallas_mis.py)
# ---------------------------------------------------------------------------

from gpuraytracer_tpu.ops import render_mis_pallas_interpret  # noqa: E402
from gpuraytracer_tpu.render import render_mis  # noqa: E402


def _mis_cfg(**kw):
    base = dict(width=32, height=16, integrator="mis", camera_rays=1,
                mis_samples=6, pixel_chunk=512)
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.smoke
def test_mis_kernel_matches_jnp_oracle(scene):
    cfg = _mis_cfg()
    oracle = np.asarray(render_mis(scene, cfg).hdr)
    kernel = np.asarray(render_mis_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=5e-4, rtol=1e-3)


def test_mis_kernel_two_camera_rays(scene):
    cfg = _mis_cfg(camera_rays=2, mis_samples=3)
    oracle = np.asarray(render_mis(scene, cfg).hdr)
    kernel = np.asarray(render_mis_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=5e-4, rtol=1e-3)


def test_mis_kernel_sphere_scene(sphere_scene):
    """Analytic spheres in the MIS megakernel (closest hit, shadow probes,
    sphere normals/materials) match the oracle (VERDICT r1 item 9)."""
    cfg = _mis_cfg(width=32, height=32)
    oracle = np.asarray(render_mis(sphere_scene, cfg).hdr)
    kernel = np.asarray(render_mis_pallas_interpret(sphere_scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=5e-4, rtol=1e-3)


def test_mis_kernel_nonsquare_non_tile_multiple():
    scene = cornell_box(resolution=(24, 18))
    cfg = _mis_cfg(width=24, height=18)
    oracle = np.asarray(render_mis(scene, cfg).hdr)
    kernel = np.asarray(render_mis_pallas_interpret(scene, cfg))
    assert kernel.shape == (18, 24, 3)
    np.testing.assert_allclose(kernel, oracle, atol=5e-4, rtol=1e-3)


def test_mis_kernel_backward_matches_jnp_grad(scene):
    """The custom VJP (jnp fallback) produces the oracle's gradients."""
    import dataclasses
    import jax.numpy as jnp
    from gpuraytracer_tpu.ops import render_mis_pallas

    cfg = _mis_cfg(mis_samples=3)

    def loss_pallas(em):
        light = dataclasses.replace(scene.light, emitted_radiance=em)
        s = dataclasses.replace(scene, light=light)
        return jnp.mean(render_mis_pallas(s, cfg))

    def loss_jnp(em):
        light = dataclasses.replace(scene.light, emitted_radiance=em)
        s = dataclasses.replace(scene, light=light)
        return jnp.mean(render_mis(s, cfg).hdr)

    em = jnp.asarray(scene.light.emitted_radiance)
    g_k = np.asarray(jax.grad(loss_pallas)(em))
    g_j = np.asarray(jax.grad(loss_jnp)(em))
    np.testing.assert_allclose(g_k, g_j, atol=1e-7, rtol=1e-5)


def test_kernel_sphere_scene_matches_oracle():
    """Analytic sphere intersection in the megakernel
    (shaders_old.metal:108-136 tier)."""
    from gpuraytracer_tpu.scene import cornell_box_with_spheres

    scene = cornell_box_with_spheres(resolution=(32, 16))
    cfg = _cfg(spp=1)
    oracle = np.asarray(render(scene, cfg).hdr)
    kernel = np.asarray(render_path_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# Stratified sampler + glossy materials (BASELINE config 3)
# ---------------------------------------------------------------------------

def test_stratified_path_kernel_matches_oracle(scene):
    """Stratified camera jitter: kernel's f32 divmod grid == oracle's
    sampling.stratified2 (requires square spp)."""
    cfg = _cfg(spp=4, sampler="stratified")
    oracle = np.asarray(render(scene, cfg).hdr)
    kernel = np.asarray(render_path_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=2e-5, rtol=1e-4)


def test_stratified_mis_kernel_matches_oracle_glossy():
    """Config 3: glossy/specular Cornell variant, stratified strategy
    tables, MIS integrator — kernel == oracle."""
    from gpuraytracer_tpu.scene import cornell_box_glossy
    scene = cornell_box_glossy(resolution=(32, 16))
    cfg = _mis_cfg(mis_samples=12, sampler="stratified")
    oracle = np.asarray(render_mis(scene, cfg).hdr)
    kernel = np.asarray(render_mis_pallas_interpret(scene, cfg))
    np.testing.assert_allclose(kernel, oracle, atol=5e-4, rtol=1e-3)


def test_stratified_covers_cells():
    """Property: stratified2 places sample i in cell i%n of a sqrt(n) grid."""
    import jax.numpy as jnp
    from gpuraytracer_tpu import sampling as smp
    n = 16
    pts = np.asarray(smp.stratified2(jnp.arange(n, dtype=jnp.uint32), 0, n))
    assert pts.shape == (n, 2)
    assert (pts >= 0).all() and (pts < 1).all()
    cells = set()
    for i in range(n):
        cells.add((int(pts[i, 0] * 4), int(pts[i, 1] * 4)))
    assert len(cells) == n  # every cell covered exactly once
