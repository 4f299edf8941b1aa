"""Multi-device rendering on the FAST kernel paths.

parallel/mesh.py shards the jnp oracle renderer; this module shards the
trace kernels + hand-written backwards instead, with the usual recipe:
pixels sharded over the ``rays`` mesh axis, scene replicated, parameter
gradients all-reduced by shard_map's transpose (a psum over ``rays`` that
XLA hands to NCCL).

Correctness hinges on the kernels' RNG being a pure function of the GLOBAL
pixel id (SURVEY.md §7): each shard passes its first pixel id (``rid_base``)
into the kernel, so the sharded image is bit-identical to the single-device
one per pixel.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.pallas_shade import render_path_fused_local
from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from .mesh import RAY_AXIS


def render_path_fused_sharded(scene: Scene, config: RenderConfig, mesh,
                              interpret=None,
                              records_only=None) -> jnp.ndarray:
    """Differentiable variant-B render, pixels sharded over ``rays``, on the
    trace kernel + hand-written backward. Returns the global [H, W, 3] hdr.

    Requires num_pixels % n_devices == 0; each shard pads its slice to a
    whole ray tile internally (pad lanes render duplicate pixels whose
    outputs are truncated and whose upstream cotangents are zero)."""
    n_dev = mesh.shape[RAY_AXIS]
    n_pixels = config.num_pixels
    if n_pixels % n_dev:
        raise ValueError(
            f"{n_pixels} pixels must split evenly across {n_dev} devices")
    local = n_pixels // n_dev
    offsets = pixel_rng_offsets(config)
    # Auto axis type: Explicit meshes demand a global jax.set_mesh context
    # (illegal under an outer jit/grad trace); Auto keeps sharding decisions
    # inside this function.
    mesh = jax.make_mesh((n_dev,), (RAY_AXIS,),
                         devices=list(mesh.devices.flat),
                         axis_types=(jax.sharding.AxisType.Auto,))

    # check_vma=False: pallas_call outputs carry no varying-manual-axes
    # annotation, which the checker (on by default) rejects; every output
    # here is genuinely shard-varying via the offsets/rid_base inputs.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(RAY_AXIS)), out_specs=P(RAY_AXIS),
             check_vma=False)
    def run(scene_, offsets_):
        k = jax.lax.axis_index(RAY_AXIS)
        rid_base = (k * local).astype(jnp.int32).reshape(1, 1)
        return render_path_fused_local(scene_, config, offsets_, rid_base,
                                       interpret=interpret,
                                       records_only=records_only)

    # Under jit + an active mesh context the partitioner stitches the
    # pallas_call outputs' shard layouts; eager shard_map trips over the
    # kernel's unannotated (GSPMD replicated) result sharding.
    hdr = jax.jit(run)(scene, offsets)
    return hdr.reshape(config.height, config.width, 3)


def render_mis_fused_sharded(scene: Scene, config: RenderConfig, mesh,
                             interpret=None, occluders=None) -> jnp.ndarray:
    """Differentiable variant-A MIS render, pixels sharded over ``rays``,
    on the MIS trace kernel + hand-written backward.
    Returns the global [H, W, 3] hdr; sharded == single-device bit-identical
    per pixel (the kernels' jitter is a pure function of the global pixel
    id threaded via rid_base)."""
    from ..ops.pallas_mis_bwd import render_mis_fused_local

    n_dev = mesh.shape[RAY_AXIS]
    n_pixels = config.num_pixels
    if n_pixels % n_dev:
        raise ValueError(
            f"{n_pixels} pixels must split evenly across {n_dev} devices")
    local = n_pixels // n_dev
    mesh = jax.make_mesh((n_dev,), (RAY_AXIS,),
                         devices=list(mesh.devices.flat),
                         axis_types=(jax.sharding.AxisType.Auto,))
    # The kernel needs no per-pixel input; a sharded dummy pins the output
    # layout (see render_path_fused_sharded's check_vma note).
    dummy = jnp.zeros((n_pixels,), jnp.int32)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(RAY_AXIS)), out_specs=P(RAY_AXIS),
             check_vma=False)
    def run(scene_, dummy_):
        k = jax.lax.axis_index(RAY_AXIS)
        rid_base = (k * local).astype(jnp.int32).reshape(1, 1)
        return render_mis_fused_local(scene_, config, local, rid_base,
                                      interpret=interpret,
                                      occluders=occluders)

    hdr = jax.jit(run)(scene, dummy)
    return hdr.reshape(config.height, config.width, 3)


def make_overlapped_grad_fn(scene_template: Scene, config: RenderConfig,
                            mesh, n_microtiles: int = 4, interpret=None):
    """Forward + backward + gradient all-reduce, with the all-reduce
    issued per microtile so it can overlap the backward pass (BASELINE
    north-star; SURVEY.md §2.4 comm-backend row).

    The plain fused path (render_path_fused_sharded) lets shard_map's
    transpose insert ONE psum per parameter at the very end of the
    backward. Here each shard splits its pixel slice into ``n_microtiles``
    chunks and runs the full fwd+bwd per chunk, psum'ing that chunk's
    parameter cotangents immediately, so the collective of chunk k is
    independent of chunk k+1's compute. Gradient sums are mathematically
    identical to the single-psum design (fp order differs). XLA's
    all-reduce combiner may merge the per-microtile psums back into one;
    whether the overlap happens on a given device is read from a profiler
    trace, not assumed.

    Returns ``grad_fn(scene, target) -> (loss, grads)`` where loss is the
    global image MSE and grads is a scene-pytree cotangent (int leaves
    untouched). jit it at the call site."""
    n_dev = mesh.shape[RAY_AXIS]
    n_pixels = config.num_pixels
    if n_pixels % n_dev:
        raise ValueError(
            f"{n_pixels} pixels must split evenly across {n_dev} devices")
    local = n_pixels // n_dev
    if local % n_microtiles:
        raise ValueError(f"{local} shard pixels must split into "
                         f"{n_microtiles} microtiles")
    mt = local // n_microtiles
    offsets = pixel_rng_offsets(config)
    amesh = jax.make_mesh((n_dev,), (RAY_AXIS,),
                          devices=list(mesh.devices.flat),
                          axis_types=(jax.sharding.AxisType.Auto,))
    inv_n = 1.0 / (n_pixels * 3)

    def _psum_floats(tree):
        return jax.tree.map(
            lambda x: (jax.lax.psum(x, RAY_AXIS)
                       if hasattr(x, "dtype") and x.dtype == jnp.float32
                       else x), tree)

    def grad_fn(scene: Scene, target):
        target_flat = target.reshape(-1, 3)

        @partial(jax.shard_map, mesh=amesh,
                 in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS)),
                 out_specs=(P(), P()),
                 check_vma=False)
        def run(scene_, offsets_, target_):
            k_dev = jax.lax.axis_index(RAY_AXIS)

            def mt_loss(s, i):
                rid_base = (k_dev * local + i * mt).astype(
                    jnp.int32).reshape(1, 1)
                hdr = render_path_fused_local(
                    s, config, jax.lax.dynamic_slice_in_dim(
                        offsets_, i * mt, mt, 0),
                    rid_base, interpret=interpret)
                tgt = jax.lax.dynamic_slice_in_dim(target_, i * mt, mt, 0)
                return jnp.sum((hdr - tgt) ** 2)

            loss_acc = jnp.float32(0.0)
            grads_acc = None
            for i in range(n_microtiles):
                li, gi = jax.value_and_grad(
                    lambda s: mt_loss(s, i), allow_int=True)(scene_)
                # Per-microtile psum — the overlap point: this collective
                # is independent of microtile i+1's compute.
                gi = _psum_floats(gi)
                loss_acc = loss_acc + li
                grads_acc = gi if grads_acc is None else jax.tree.map(
                    lambda a, b: a + b if hasattr(a, "dtype")
                    and a.dtype == jnp.float32 else a, grads_acc, gi)
            loss = jax.lax.psum(loss_acc, RAY_AXIS) * inv_n
            # The microtile losses are raw SSE sums; the global loss is the
            # mean — scale the accumulated cotangents to match d(mean)/dθ.
            grads_acc = jax.tree.map(
                lambda x: x * inv_n if hasattr(x, "dtype")
                and x.dtype == jnp.float32 else x, grads_acc)
            return loss, grads_acc

        return run(scene, offsets, target_flat)

    return grad_fn
