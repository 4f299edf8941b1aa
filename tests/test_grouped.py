"""Grouped primitive traversal (pallas_path.closest_tris/occluded_tris):
one loop over AABB-skipped groups of GROUP triangles for every scene size.

The kernels must make the oracle's decisions on the 36-triangle box and on
tessellated-mesh scenes (252 triangles here; 1k+ in benchmarks), and the
fused fwd+bwd pair must match the jnp oracle there. Interpret mode on
CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer_tpu.ops.pallas_path import GROUP, _render_pallas_impl
from gpuraytracer_tpu.ops.pallas_shade import render_path_decoupled_fused
from gpuraytracer_tpu.render import render
from gpuraytracer_tpu.scene import cornell_box, cornell_box_tessellated
from gpuraytracer_tpu.types import RenderConfig

_CFG = RenderConfig(width=16, height=8, integrator="path", spp=2, bounces=2,
                    pixel_chunk=128)


@pytest.fixture(scope="module")
def tess_scene():
    s = cornell_box_tessellated(resolution=(16, 8), wall_subdiv=3,
                                sphere_subdiv=1)
    assert s.triangles.num_triangles > 8 * GROUP   # many groups
    return s


@pytest.mark.smoke
def test_grouped_equals_static_unroll():
    """The 36-triangle box (3 groups, the size the retired static unroll
    served) through the grouped loop: the oracle's decisions and
    values."""
    s = cornell_box(resolution=(16, 8))
    k = np.asarray(_render_pallas_impl(s, _CFG, interpret=True))
    o = np.asarray(render(s, _CFG).hdr)
    np.testing.assert_allclose(k, o, atol=2e-5, rtol=1e-4)


def test_tessellated_forward_matches_oracle(tess_scene):
    k = np.asarray(_render_pallas_impl(tess_scene, _CFG, interpret=True))
    o = np.asarray(render(tess_scene, _CFG).hdr)
    np.testing.assert_allclose(k, o, atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def tess_grads(tess_scene):
    g_f = jax.grad(
        lambda s: jnp.mean(render_path_decoupled_fused(s, _CFG)),
        allow_int=True)(tess_scene)
    g_o = jax.grad(lambda s: jnp.mean(render(s, _CFG).hdr),
                   allow_int=True)(tess_scene)
    return g_f, g_o


@pytest.mark.parametrize("group", [
    "triangles.verts", "triangles.diffuse", "triangles.emissive",
    "light.color", "light.center", "camera.position", "camera.direction",
])
def test_tessellated_grads_match_oracle(tess_grads, group):
    g_f, g_o = tess_grads
    a, b = g_f, g_o
    for part in group.split("."):
        a, b = getattr(a, part), getattr(b, part)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(b).max() > 0.0, f"oracle grad for {group} is all-zero"
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)


def test_tessellated_records_only_grads_match(tess_scene):
    """Grouped + records_only (in-kernel RNG regeneration, config-5 memory
    mode): same gradients as the plane mode."""
    g_a = jax.grad(
        lambda s: jnp.mean(render_path_decoupled_fused(
            s, _CFG, records_only=True)), allow_int=True)(tess_scene)
    g_b = jax.grad(
        lambda s: jnp.mean(render_path_decoupled_fused(
            s, _CFG, records_only=False)), allow_int=True)(tess_scene)
    for a, b in zip(jax.tree.leaves(g_a), jax.tree.leaves(g_b)):
        if hasattr(a, "dtype") and a.dtype == jnp.float32:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=5e-8, rtol=1e-5)


def test_blocked_tiles_match_oracle():
    """Pixel-tile (BLOCK_W x TILE/BLOCK_W) mapping: the kernel's hdr
    and fused gradients equal the oracle's — the mapping is a pure pixel
    permutation applied consistently to offsets/records/cotangents."""
    from gpuraytracer_tpu.ops.pallas_path import use_blocked_tiles
    s = cornell_box_tessellated(resolution=(64, 64), wall_subdiv=3,
                                sphere_subdiv=1)
    cfg = RenderConfig(width=64, height=64, integrator="path", spp=2,
                       bounces=2, pixel_chunk=4096)
    assert use_blocked_tiles(cfg, False)
    k = np.asarray(_render_pallas_impl(s, cfg, interpret=True))
    o = np.asarray(render(s, cfg).hdr)
    np.testing.assert_allclose(k, o, atol=2e-5, rtol=1e-4)
    g_f = jax.grad(
        lambda sc: jnp.mean(render_path_decoupled_fused(sc, cfg)),
        allow_int=True)(s)
    g_o = jax.grad(lambda sc: jnp.mean(render(sc, cfg).hdr),
                   allow_int=True)(s)
    for grp in ("triangles.verts", "triangles.diffuse", "light.center",
                "camera.position"):
        a, b = g_f, g_o
        for part in grp.split("."):
            a, b = getattr(a, part), getattr(b, part)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-4, err_msg=grp)


def test_tessellated_occluders_preserve_render(tess_scene):
    """Occluder culling on the grouped path (dense host-packed shadow
    table): masked and full-loop renders agree."""
    from gpuraytracer_tpu.intersect import potential_occluders
    occ = potential_occluders(tess_scene, _CFG)
    assert not all(occ), "tessellated walls should be culled"
    a = np.asarray(_render_pallas_impl(tess_scene, _CFG, interpret=True,
                                       occluders=occ))
    b = np.asarray(_render_pallas_impl(tess_scene, _CFG, interpret=True))
    np.testing.assert_allclose(a, b, atol=5e-8, rtol=1e-6)
