"""Numerical-debug toggles (SURVEY.md §5 "race detection / sanitizers").

The reference has no sanitizers (its kernels are embarrassingly parallel
with disjoint writes); JAX's functional purity gives the same property for
free. What remains worth toggling:

  * NaN debugging — ``jax_debug_nans`` aborts the first op producing a NaN
    with a traceback (the analog of a device-side assert);
  * buffer-donation discipline — ``jax_debug_infs`` and disabling donation
    catch aliasing surprises when iterating on the accumulator/train-step
    paths.

Use as a context manager around a render/train call, or process-wide via
``enable(...)``:

    with debug_checks(nans=True):
        hdr = render(scene, config).hdr
"""
from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def debug_checks(nans: bool = True, infs: bool = False,
                 disable_jit: bool = False):
    """Temporarily enable JAX numerical debugging. NaN/Inf checks force
    sync execution and re-run failing ops un-jitted for a precise
    traceback — use on small shapes."""
    ctx = []
    if nans:
        ctx.append(("jax_debug_nans", True))
    if infs:
        ctx.append(("jax_debug_infs", True))
    if disable_jit:
        ctx.append(("jax_disable_jit", True))
    olds = [(k, getattr(jax.config, k)) for k, _ in ctx]
    try:
        for k, v in ctx:
            jax.config.update(k, v)
        yield
    finally:
        for k, v in olds:
            jax.config.update(k, v)


def enable(nans: bool = True, infs: bool = False) -> None:
    """Process-wide variant (e.g. from the CLI's --debug-nans flag)."""
    if nans:
        jax.config.update("jax_debug_nans", True)
    if infs:
        jax.config.update("jax_debug_infs", True)
