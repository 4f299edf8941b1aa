"""Differentiable + inverse rendering (BASELINE config 4).

The reference has no autodiff — this capability is mandated by BASELINE.json:
"radiance is differentiable w.r.t. material albedo/roughness, light emission,
and sphere geometry ... recover sphere albedo + light emission + sphere
centers from target image via pixel-loss gradients".

Design: the renderer (render.py) is already differentiable w.r.t. every
scene array — hit distances/normals are smooth functions of the winning
primitive's parameters (interior gradients), material/emission gradients flow
through the gather + shading math, and visibility masks are step functions
treated as piecewise-constant (their gradient contribution is zero away from
edges). That is exactly the right estimator for albedo/emission and a biased
-but-useful one for geometry; edge-aware reparameterization is layered on
top later without changing this API.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..render import render
from ..types import RenderConfig, Scene


class SceneParams(NamedTuple):
    """The optimizable subset of a scene (config 4's unknowns)."""

    sphere_centers: jnp.ndarray   # [S, 3]
    sphere_diffuse: jnp.ndarray   # [S, 3]
    light_emission: jnp.ndarray   # [3] (light.emitted_radiance scale)


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(
        sphere_centers=jnp.asarray(scene.spheres.center),
        sphere_diffuse=jnp.asarray(scene.spheres.diffuse),
        light_emission=jnp.asarray(scene.light.color),
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    """Inject optimizable parameters into a scene pytree (functional update)."""
    spheres = dataclasses.replace(
        scene.spheres,
        center=params.sphere_centers,
        diffuse=jnp.clip(params.sphere_diffuse, 0.0, 1.0),
    )
    light = dataclasses.replace(scene.light, color=params.light_emission)
    return dataclasses.replace(scene, spheres=spheres, light=light)


def render_hdr(scene: Scene, config: RenderConfig) -> jnp.ndarray:
    return render(scene, config).hdr


def pixel_loss(params: SceneParams, scene: Scene, config: RenderConfig,
               target: jnp.ndarray) -> jnp.ndarray:
    """Mean squared pixel loss of the re-rendered image vs target
    (interior gradients only — fine for albedo/emission)."""
    img = render_hdr(apply_params(scene, params), config)
    return jnp.mean((img - target) ** 2)


def fast_pixel_loss(params: SceneParams, scene: Scene, config: RenderConfig,
                    target: jnp.ndarray, draws=None,
                    occluders=None) -> jnp.ndarray:
    """``pixel_loss`` through the fused kernel pair (Pallas trace forward +
    hand-written Pallas backward, ops/pallas_shade.py — sphere scenes take
    the analytic-sphere branch), with identical (interior) gradients. Records are re-traced every
    step at the current parameters, so the piecewise-constant visibility is
    always evaluated at the live scene — the same estimator as
    ``pixel_loss``. This is BASELINE config 4's optax loop at kernel
    speed (``inverse_render(..., fast=True)``).

    ``draws``/``occluders``: step-invariant amortizations, computed ONCE by
    the caller OUTSIDE the training scan (``inverse_render`` does this) —
    the draws are a pure function of config, and the occluder mask is built
    with enough ``sphere_slack`` to stay sound while centers move. Left
    inside a scan body, the draws may be recomputed every step."""
    from ..ops import render_path_decoupled
    img = render_path_decoupled(apply_params(scene, params), config,
                                draws=draws, occluders=occluders)
    return jnp.mean((img - target) ** 2)


def soft_pixel_loss(params: SceneParams, scene: Scene, config: RenderConfig,
                    target: jnp.ndarray, kappa: float = 0.05) -> jnp.ndarray:
    """Pixel loss through the edge-aware renderer (diff_render.py): same
    forward value as the hard render, plus sphere-silhouette gradient
    terms — required for geometry (sphere-center) recovery."""
    from .diff_render import render_direct_soft
    img = render_direct_soft(apply_params(scene, params), config, kappa)
    return jnp.mean((img - target) ** 2)


loss_and_grad = jax.jit(jax.value_and_grad(pixel_loss),
                        static_argnums=(2,))


class InverseResult(NamedTuple):
    params: SceneParams
    losses: jnp.ndarray  # [steps]


def inverse_render(
    scene: Scene,
    target: jnp.ndarray,
    init_params: SceneParams,
    config: RenderConfig,
    steps: int = 100,
    learning_rate: float = 5e-2,
    optimizer=None,
    soft: bool = False,
    kappa: float = 0.05,
    fast: bool = False,
    sphere_slack: float = 0.5,
    hoist: bool = True,
) -> InverseResult:
    """Gradient-descent recovery of scene parameters from a target image.

    ``soft=True`` switches to the edge-aware loss (needed when sphere
    geometry is among the unknowns; it runs on the jnp renderer
    diff_render.render_direct_soft, which has no kernel, so passing
    ``fast=True`` with it raises ValueError);
    with it, plain SGD + momentum tracks the tiny silhouette gradients more
    reliably than adam (whose per-parameter normalization amplifies plateau
    noise), so that's the soft-mode default. The whole loop runs as one
    jitted lax.scan so multi-step optimization is a single device program.

    ``fast=True`` renders through the kernel pair (trace kernel +
    hand-written backward) and hoists the two step-invariant amortizations
    out of the scan: the pregenerated Halton draw planes
    (``pallas_path.pregen_draws`` — pure function of config) and the static
    occluder mask (``intersect.potential_occluders`` built with
    ``sphere_slack`` of center-motion headroom, so the mask stays
    conservative for every iterate the optimizer can reach; raise
    ``sphere_slack`` if recovering shifts larger than it). ``hoist=False``
    disables both (benchmark knob — quantifies what XLA's sinking of the
    pregen into the scan body costs; see benchmarks/bench_config4.py)."""
    import optax

    if soft and fast:
        raise ValueError("soft=True runs the jnp soft renderer, which has no "
                         "kernel: drop fast=True")
    if optimizer is not None:
        opt = optimizer
    elif soft:
        opt = optax.sgd(learning_rate, momentum=0.9)
    else:
        opt = optax.adam(learning_rate)
    if soft:
        loss_fn = partial(soft_pixel_loss, kappa=kappa)
    elif fast:
        if hoist:
            from ..intersect import potential_occluders
            from ..ops.pallas_path import pregen_draws
            from ..ops.pallas_shade import _auto_records_only
            occluders = potential_occluders(scene, config,
                                            sphere_slack=sphere_slack)
            draws = (None if _auto_records_only(config)
                     else pregen_draws(config))
        else:
            draws = occluders = None
        loss_fn = partial(fast_pixel_loss, draws=draws, occluders=occluders)
    else:
        loss_fn = pixel_loss

    @partial(jax.jit, static_argnums=())
    def run(init_params, target):
        opt_state = opt.init(init_params)

        def step(carry, _):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(
                params, scene, config, target)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, _), losses = jax.lax.scan(
            step, (init_params, opt_state), None, length=steps)
        return params, losses

    params, losses = run(init_params, target)
    return InverseResult(params=params, losses=losses)


def finite_difference_grad(
    f: Callable[[jnp.ndarray], jnp.ndarray], x: jnp.ndarray, eps: float = 1e-3
) -> jnp.ndarray:
    """Central finite differences, elementwise — the gradient oracle for
    tests (SURVEY.md §4.4)."""
    flat = x.reshape(-1)
    grads = []
    for i in range(flat.shape[0]):
        e = jnp.zeros_like(flat).at[i].set(eps).reshape(x.shape)
        grads.append((f(x + e) - f(x - e)) / (2 * eps))
    return jnp.stack(grads).reshape(x.shape)
