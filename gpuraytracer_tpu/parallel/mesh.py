"""Device mesh + sharded rendering (SURVEY.md §2.4).

The reference is single-device (one Metal queue, blocking waits,
renderer.swift:144); here the *pixel/ray batch* shards across a 1-D
``rays`` mesh axis (data-parallel analog), scene parameters stay
replicated, and reductions are XLA collectives (``psum``, NCCL on GPUs).
A flat 1-D mesh suits NVLink's all-to-all links: every card reaches every
other at the same rate. Because all randomness is a pure
function of (pixel, sample, bounce, dim), the sharded render is
bit-identical to the single-device render — asserted in tests.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..render import _path_trace_chunk, pixel_coords, pixel_rng_offsets
from ..intersect import compile_scene
from ..types import RenderConfig, Scene

RAY_AXIS = "rays"


def make_ray_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or given) devices; axis name ``rays``."""
    devices = list(devices) if devices is not None else jax.devices()
    return jax.make_mesh((len(devices),), (RAY_AXIS,), devices=devices)


def render_path_sharded(scene: Scene, config: RenderConfig, mesh: Mesh):
    """Variant-B path render with pixels sharded over the ``rays`` axis and
    the scene replicated. Returns [H, W, 3] HDR (global array)."""
    n_dev = mesh.shape[RAY_AXIS]
    n_pixels = config.num_pixels
    if n_pixels % n_dev:
        raise ValueError(f"{n_pixels} pixels not divisible by {n_dev} devices")

    compiled = compile_scene(scene.triangles, config.lane_pad)
    px, py = pixel_coords(config)
    offsets = pixel_rng_offsets(config)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
    )
    def shard_render(compiled_, scene_, px_, py_, offsets_):
        return _path_trace_chunk(compiled_, scene_, config, px_, py_, offsets_)

    hdr = shard_render(compiled, scene, px, py, offsets)
    return hdr.reshape(config.height, config.width, 3)


def make_sharded_renderer(config: RenderConfig, mesh: Mesh):
    """jit-compiled sharded renderer: scene -> [H, W, 3]."""
    def fn(scene: Scene):
        return render_path_sharded(scene, config, mesh)
    return jax.jit(fn)


def psum_mean(x: jnp.ndarray, axis_name: str = RAY_AXIS) -> jnp.ndarray:
    """Mean across the mesh axis (metric reduction helper)."""
    return jax.lax.pmean(x, axis_name)


# ---------------------------------------------------------------------------
# Sample-axis (spp) sharding — the sequence-parallel analog (SURVEY.md §2.4:
# the reference's long axis is samples-per-pixel, a serial in-thread loop at
# raytrace.metal:34; here it shards across the mesh with a psum sample-mean).
# ---------------------------------------------------------------------------

SPP_AXIS = "spp"


def make_ray_spp_mesh(n_rays: int, n_spp: int,
                      devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """2-D mesh: pixels shard over ``rays``, samples over ``spp`` (the
    ``spp`` axis innermost)."""
    devices = list(devices) if devices is not None else jax.devices()
    if len(devices) != n_rays * n_spp:
        raise ValueError(f"need {n_rays * n_spp} devices, got {len(devices)}")
    return jax.make_mesh((n_rays, n_spp), (RAY_AXIS, SPP_AXIS),
                         devices=devices)


def render_path_spp_sharded(scene: Scene, config: RenderConfig, mesh: Mesh):
    """Variant-B render with the *sample* axis sharded: each device renders
    every assigned pixel at spp/n_spp samples using a disjoint slice of the
    global Halton sample set, then the radiance means reduce with a psum.

    Because sample index ``n`` enters only through the per-pixel Halton index
    ``offset + n`` (render._path_trace_chunk), shifting the offset by
    ``device * spp_local`` partitions the exact same global sample set — the
    sharded estimate equals the single-device one up to fp summation order
    (allclose, not bit-equal; the pixel-sharded path is the bit-stable one).

    Works with an ``spp``-only 1-D mesh or a 2-D (rays, spp) mesh; pixels
    shard over ``rays`` when present.
    """
    n_spp_dev = mesh.shape[SPP_AXIS]
    has_rays = RAY_AXIS in mesh.shape
    n_ray_dev = mesh.shape[RAY_AXIS] if has_rays else 1
    if config.spp % n_spp_dev:
        raise ValueError(f"spp={config.spp} not divisible by {n_spp_dev}")
    if config.num_pixels % n_ray_dev:
        raise ValueError(
            f"{config.num_pixels} pixels not divisible by {n_ray_dev}")
    spp_local = config.spp // n_spp_dev
    local_cfg = config.replace(spp=spp_local)

    compiled = compile_scene(scene.triangles, config.lane_pad)
    px, py = pixel_coords(config)
    offsets = pixel_rng_offsets(config)

    pix_spec = P(RAY_AXIS) if has_rays else P()
    out_spec = P(RAY_AXIS) if has_rays else P()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), pix_spec, pix_spec, pix_spec),
        out_specs=out_spec,
    )
    def shard_render(compiled_, scene_, px_, py_, offsets_):
        k = jax.lax.axis_index(SPP_AXIS).astype(jnp.uint32)
        shard_offsets = offsets_ + k * jnp.uint32(spp_local)
        # Mark the pixel coords device-varying over ``spp`` (they feed the
        # scan carry via render._zeros3; without this the carry's manual-axes
        # type differs from the loop body's, which picks up spp through the
        # offsets) — same trick as render._zeros3, arithmetic not pcast so it
        # holds across jax versions.
        px_ = px_ + (shard_offsets * jnp.uint32(0)).astype(px_.dtype)
        lum = _path_trace_chunk(compiled_, scene_, local_cfg, px_, py_,
                                shard_offsets)
        # Global sample mean: each shard's lum is already a mean over its
        # spp_local slice; equal slice sizes => pmean over the spp axis.
        return jax.lax.pmean(lum, SPP_AXIS)

    hdr = shard_render(compiled, scene, px, py, offsets)
    return hdr.reshape(config.height, config.width, 3)
