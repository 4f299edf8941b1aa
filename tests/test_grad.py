"""Gradient tests (SURVEY.md §4.4): AD vs finite differences for material /
emission / sphere-center parameters; inverse-rendering convergence smoke."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer_tpu.grad.inverse import (SceneParams, apply_params,
                                           extract_params,
                                           finite_difference_grad,
                                           inverse_render, pixel_loss,
                                           render_hdr)
from gpuraytracer_tpu.scene import cornell_box_with_spheres
from gpuraytracer_tpu.types import RenderConfig


@pytest.fixture(scope="module")
def scene():
    return cornell_box_with_spheres(resolution=(24, 24))


def _cfg(**kw):
    base = dict(width=24, height=24, integrator="direct", spp=2, bounces=1,
                pixel_chunk=576)
    base.update(kw)
    return RenderConfig(**base)


def test_grad_wrt_light_emission_matches_fd(scene):
    cfg = _cfg()

    def f(scale):
        light = dataclasses.replace(scene.light,
                                    color=scene.light.color * scale)
        s = dataclasses.replace(scene, light=light)
        return jnp.mean(render_hdr(s, cfg))

    g_ad = float(jax.grad(f)(jnp.float32(1.0)))
    g_fd = float(finite_difference_grad(f, jnp.float32(1.0), 1e-2))
    assert g_ad == pytest.approx(g_fd, rel=1e-3)
    assert g_ad > 0


def test_grad_wrt_sphere_albedo_matches_fd(scene):
    cfg = _cfg()

    def f(scale):
        spheres = dataclasses.replace(scene.spheres,
                                      diffuse=scene.spheres.diffuse * scale)
        s = dataclasses.replace(scene, spheres=spheres)
        return jnp.mean(render_hdr(s, cfg))

    g_ad = float(jax.grad(f)(jnp.float32(1.0)))
    g_fd = float(finite_difference_grad(f, jnp.float32(1.0), 1e-2))
    assert g_ad == pytest.approx(g_fd, rel=1e-3)
    assert g_ad > 0  # brighter spheres -> brighter image


def test_grad_wrt_sphere_center_nonzero_and_close_to_fd(scene):
    """Interior gradient w.r.t. sphere center: finite differences include
    silhouette jumps that interior AD deliberately ignores, so compare the
    smooth component loosely and require the AD gradient to be nonzero and
    finite."""
    cfg = _cfg()
    c0 = jnp.asarray(scene.spheres.center)

    def f(dz):
        center = c0 + jnp.array([0.0, 0.0, 1.0]) * dz
        spheres = dataclasses.replace(scene.spheres, center=center)
        s = dataclasses.replace(scene, spheres=spheres)
        return jnp.mean(render_hdr(s, cfg))

    g_ad = float(jax.grad(f)(jnp.float32(0.0)))
    assert np.isfinite(g_ad) and g_ad != 0.0
    # Small-eps FD stays within one visibility cell, so it measures the same
    # interior gradient AD computes (eps >= 0.02 crosses a silhouette here
    # and flips sign — that jump term is deliberately not in the estimator).
    g_fd = float(finite_difference_grad(f, jnp.float32(0.0), 1e-2))
    assert g_ad == pytest.approx(g_fd, rel=5e-3)


def test_pixel_loss_zero_at_truth(scene):
    cfg = _cfg()
    params = extract_params(scene)
    target = render_hdr(apply_params(scene, params), cfg)
    assert float(pixel_loss(params, scene, cfg, target)) == 0.0


def test_inverse_rendering_recovers_emission_and_albedo(scene):
    """Config-4 smoke: perturb light emission + sphere albedo, recover by
    gradient descent on the pixel loss."""
    cfg = _cfg(spp=1)
    true_params = extract_params(scene)
    target = render_hdr(apply_params(scene, true_params), cfg)

    init = SceneParams(
        sphere_centers=true_params.sphere_centers,
        sphere_diffuse=jnp.clip(true_params.sphere_diffuse * 0.5, 0.05, 1.0),
        light_emission=true_params.light_emission * 1.8,
    )
    res = inverse_render(scene, target, init, cfg, steps=150,
                         learning_rate=3e-2)
    losses = np.asarray(res.losses)
    assert losses[-1] < losses[0] * 0.05  # converged
    np.testing.assert_allclose(np.asarray(res.params.light_emission),
                               np.asarray(true_params.light_emission),
                               atol=0.08)


def test_soft_forward_matches_hard(scene):
    """The edge-aware renderer's *value* is the hard render exactly
    (forward-exact / backward-soft)."""
    from gpuraytracer_tpu.grad.diff_render import render_direct_soft
    cfg = _cfg(spp=2)
    hard = np.asarray(render_hdr(scene, cfg))
    soft = np.asarray(render_direct_soft(scene, cfg))
    np.testing.assert_allclose(soft, hard, atol=1e-6)


def test_inverse_rendering_recovers_sphere_center_shift(scene):
    """Geometry recovery (config 4's hardest ask): sphere translations are
    recoverable only with the edge-aware (silhouette) gradients — interior
    gradients alone diverge."""
    import optax
    cfg = _cfg(width=32, height=32, spp=2, pixel_chunk=1024)
    scene32 = cornell_box_with_spheres(resolution=(32, 32))
    true_params = extract_params(scene32)
    target = render_hdr(apply_params(scene32, true_params), cfg)

    init = SceneParams(
        sphere_centers=true_params.sphere_centers
        + jnp.array([[0.15, 0.0, -0.1], [-0.1, 0.05, 0.1]]),
        sphere_diffuse=true_params.sphere_diffuse,
        light_emission=true_params.light_emission,
    )
    res = inverse_render(scene32, target, init, cfg, steps=400, soft=True,
                         kappa=0.1, optimizer=optax.sgd(5e2, momentum=0.9))
    losses = np.asarray(res.losses)
    assert losses[-1] < losses[0] * 0.1
    err0 = np.abs(np.asarray(init.sphere_centers)
                  - np.asarray(true_params.sphere_centers)).max()
    err1 = np.abs(np.asarray(res.params.sphere_centers)
                  - np.asarray(true_params.sphere_centers)).max()
    assert err1 < err0 * 0.5  # at least halved the worst-axis error


def test_fast_pixel_loss_grads_match_oracle(sphere_scene):
    """fast_pixel_loss (decoupled Pallas trace + replay) produces the same
    parameter gradients as pixel_loss (oracle renderer)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gpuraytracer_tpu.grad.inverse import (extract_params, fast_pixel_loss,
                                               pixel_loss)
    from gpuraytracer_tpu.types import RenderConfig

    cfg = RenderConfig(width=64, height=64, integrator="path", spp=1,
                       bounces=2, pixel_chunk=4096, replay_sample_chunk=1)
    params = extract_params(sphere_scene)
    target = jnp.zeros((64, 64, 3), jnp.float32)
    g_fast = jax.grad(fast_pixel_loss)(params, sphere_scene, cfg, target)
    g_orc = jax.grad(pixel_loss)(params, sphere_scene, cfg, target)
    for a, b in zip(jax.tree.leaves(g_fast), jax.tree.leaves(g_orc)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-4)


def test_inverse_rendering_fast_loop_converges(sphere_scene):
    """BASELINE config 4's optax loop on the FUSED kernel path
    (inverse_render(..., fast=True)): recover a light-emission scale from a
    target image at kernel speed."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from gpuraytracer_tpu.grad.inverse import (extract_params, inverse_render,
                                               render_hdr)
    from gpuraytracer_tpu.types import RenderConfig

    cfg = RenderConfig(width=32, height=16, integrator="path", spp=1,
                       bounces=2, pixel_chunk=512)
    scene32 = dataclasses.replace(
        sphere_scene,
        camera=dataclasses.replace(sphere_scene.camera, resolution=(32, 16)))
    true_params = extract_params(scene32)
    target = render_hdr(scene32, cfg)
    init = true_params._replace(
        light_emission=true_params.light_emission * 0.4)
    res = inverse_render(scene32, target, init, cfg, steps=60,
                         learning_rate=1e-2, fast=True)
    losses = np.asarray(res.losses)
    assert losses[-1] < losses[0] * 0.2
    np.testing.assert_allclose(np.asarray(res.params.light_emission),
                               np.asarray(true_params.light_emission),
                               rtol=0.15)


def test_inverse_render_soft_with_fast_raises(scene):
    """soft=True runs the jnp soft renderer, which has no kernel: asking
    for the kernel path as well is an error, not a silent fallback."""
    params = extract_params(scene)
    target = jnp.zeros((24, 24, 3), jnp.float32)
    with pytest.raises(ValueError, match="soft"):
        inverse_render(scene, target, params, _cfg(), steps=1, soft=True,
                       fast=True)
