"""Grouped traversal for the variant-A MIS kernels on tessellated meshes:
the MIS trace kernel runs the AABB-skipped group loop and the
hand-written backward replays records with gathered fetches and partial
cotangent sums. Values and ALL gradient groups must match the jnp oracle
on a tessellated scene (the reference's drawTriangle runs on any mesh via
the driver BVH, Sources/gpuRaytracer/shaders.metal:459-509). Interpret
mode on CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer_tpu.ops.pallas_mis_bwd import render_mis_fused
from gpuraytracer_tpu.render import render_mis
from gpuraytracer_tpu.scene import (cornell_box_tessellated,
                                    cornell_box_with_spheres)
from gpuraytracer_tpu.types import RenderConfig

_CFG = RenderConfig(width=16, height=8, integrator="mis", camera_rays=2,
                    mis_samples=6, pixel_chunk=128)


@pytest.fixture(scope="module")
def scene():
    s = cornell_box_tessellated(resolution=(16, 8), wall_subdiv=3,
                                sphere_subdiv=1)
    assert s.triangles.num_triangles > 64  # many triangle groups
    return s


@pytest.fixture(scope="module")
def grads(scene):
    g_f = jax.grad(lambda s: jnp.mean(render_mis_fused(s, _CFG)),
                   allow_int=True)(scene)
    g_o = jax.grad(lambda s: jnp.mean(render_mis(s, _CFG).hdr),
                   allow_int=True)(scene)
    return g_f, g_o


@pytest.mark.smoke
def test_mis_grouped_value_matches_oracle(scene):
    out = np.asarray(render_mis_fused(scene, _CFG))
    oracle = np.asarray(render_mis(scene, _CFG).hdr)
    np.testing.assert_allclose(out, oracle, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("group", [
    "light.emitted_radiance", "light.center", "light.normal",
    "light.width", "light.depth",
    "triangles.verts", "triangles.diffuse", "triangles.metallic",
    "triangles.roughness",
    "camera.position", "camera.direction", "camera.up",
])
def test_mis_grouped_grads_match_oracle(grads, group):
    g_f, g_o = grads
    obj_f, obj_o = g_f, g_o
    for part in group.split("."):
        obj_f = getattr(obj_f, part)
        obj_o = getattr(obj_o, part)
    a, b = np.asarray(obj_f), np.asarray(obj_o)
    assert np.abs(b).max() > 0.0, f"oracle grad for {group} is all-zero"
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, atol=1e-5 * max(scale, 1.0), rtol=2e-4)


@pytest.fixture(scope="module")
def sphere_scene():
    """Tessellated walls + ANALYTIC spheres: the grouped triangle sweep and
    the static sphere loop (plus the sphere branches of the backward's
    bounce replay) active in the same kernel."""
    tess = cornell_box_tessellated(resolution=(16, 8), wall_subdiv=3,
                                   sphere_subdiv=1)
    sph = cornell_box_with_spheres(resolution=(16, 8)).spheres
    return dataclasses.replace(tess, spheres=sph)


def test_mis_grouped_sphere_value_matches_oracle(sphere_scene):
    out = np.asarray(render_mis_fused(sphere_scene, _CFG))
    oracle = np.asarray(render_mis(sphere_scene, _CFG).hdr)
    np.testing.assert_allclose(out, oracle, atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def sphere_grads(sphere_scene):
    g_f = jax.grad(lambda s: jnp.mean(render_mis_fused(s, _CFG)),
                   allow_int=True)(sphere_scene)
    g_o = jax.grad(lambda s: jnp.mean(render_mis(s, _CFG).hdr),
                   allow_int=True)(sphere_scene)
    return g_f, g_o


@pytest.mark.parametrize("group", [
    "spheres.center", "spheres.radius", "spheres.diffuse",
    "triangles.verts", "light.emitted_radiance", "camera.position",
])
def test_mis_grouped_sphere_grads_match_oracle(sphere_grads, group):
    """Flip-aware comparison (see test_mis_fused's sphere-grad note):
    isolated gate-boundary pixels legitimately carry a different — valid —
    subgradient; assert the tight bound almost everywhere and a
    1e-3-of-max-norm cap on the bounded handful of boundary elements."""
    g_f, g_o = sphere_grads
    for part in group.split("."):
        g_f = getattr(g_f, part)
        g_o = getattr(g_o, part)
    a, b = np.asarray(g_f), np.asarray(g_o)
    assert np.abs(b).max() > 0.0, f"oracle grad for {group} is all-zero"
    scale = np.abs(b).max()
    d = np.abs(a - b)
    tight = 1e-5 * max(scale, 1.0) + 2e-4 * np.abs(b)
    n_out = int((d > tight).sum())
    assert n_out <= max(3, a.size // 20), (group, n_out, a.size)
    assert d.max() <= 1e-3 * max(scale, 1.0), (group, float(d.max()), scale)


def test_mis_grouped_occluder_culling_preserves_render(scene):
    """The grouped shadow tables pack only the occluder-culled triangles;
    visibility decisions must be identical to the full loop."""
    from gpuraytracer_tpu.intersect import potential_occluders

    occ = potential_occluders(scene, _CFG)
    assert not all(occ), "expected at least one culled triangle"
    a = np.asarray(render_mis_fused(scene, _CFG, occluders=occ))
    b = np.asarray(render_mis_fused(scene, _CFG))
    np.testing.assert_allclose(a, b, atol=5e-8, rtol=1e-6)
