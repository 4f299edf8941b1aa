"""Sharded inverse-rendering training step (the "full training step" of this
framework: forward render + pixel loss + backward + optimizer update, with
pixels sharded over the ``rays`` mesh axis and scene parameters replicated).

Gradient flow: jax.grad differentiates *through* the shard_map'd renderer;
XLA inserts the parameter-gradient all-reduce (psum over ``rays``) because the
parameters are replicated while the loss pixels are sharded — the analog of
DDP gradient all-reduce (SURVEY.md §2.4).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..grad.inverse import SceneParams, apply_params
from ..types import RenderConfig, Scene
from .mesh import render_path_sharded


class TrainState(NamedTuple):
    params: SceneParams
    opt_state: tuple


def make_train_step(scene: Scene, config: RenderConfig, mesh,
                    learning_rate: float = 1e-2, optimizer=None,
                    renderer=None):
    """Returns (init_fn, step_fn):
      init_fn(params) -> TrainState
      step_fn(state, target_hdr) -> (TrainState, loss)
    step_fn is jitted inside the mesh context.

    ``renderer`` defaults to the jnp-oracle sharded renderer
    (render_path_sharded); pass ``render_path_fused_sharded``
    (parallel/fast.py) via make_train_step_fused for kernel speed."""
    import optax

    opt = optimizer or optax.adam(learning_rate)
    render_fn = renderer or render_path_sharded

    def loss_fn(params: SceneParams, target: jnp.ndarray) -> jnp.ndarray:
        s = apply_params(scene, params)
        img = render_fn(s, config, mesh)
        return jnp.mean((img - target) ** 2)

    def init_fn(params: SceneParams) -> TrainState:
        return TrainState(params=params, opt_state=opt.init(params))

    @jax.jit
    def step_fn(state: TrainState, target: jnp.ndarray):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, target)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state), loss

    return init_fn, step_fn


def make_train_step_fused(scene: Scene, config: RenderConfig, mesh,
                          learning_rate: float = 1e-2, optimizer=None):
    """Sharded training step on the FAST path: trace kernel forward +
    hand-written backward kernel per shard (parallel/fast.py), parameter
    gradients all-reduced by shard_map's transpose over ``rays``. Handles
    triangle and sphere scenes (the backward replays the analytic sphere
    quadratic in-kernel)."""
    from .fast import render_path_fused_sharded
    return make_train_step(scene, config, mesh, learning_rate, optimizer,
                           renderer=render_path_fused_sharded)
