"""How the Pallas kernels in ``ops/`` are run, and helpers they share.

Every kernel is written for Pallas's Triton route (``backend="triton"``)
and runs compiled on the GPU. The Pallas interpreter runs the same kernels
on the CPU, but only when asked for explicitly: set
``GPURT_PALLAS_INTERPRET=1`` (the test suite does, in ``tests/conftest.py``)
or pass ``interpret=True`` to an entry point. Any other backend is an
error, so a timed path can never fall back to the interpreter unnoticed.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

INTERPRET_ENV = "GPURT_PALLAS_INTERPRET"

# Warps per program (32 threads each), the same for every kernel.
NUM_WARPS = 4

# Primitives per chunk of the backward kernels' one-hot cotangent sums.
PRIM_CHUNK = 64

_F32 = jnp.float32
_I32 = jnp.int32


def interpret_mode(interpret: bool | None = None) -> bool:
    """Resolve an entry point's ``interpret`` argument to the route taken.

    ``None`` means: interpreter if ``GPURT_PALLAS_INTERPRET=1``, otherwise
    the compiled Triton route, which needs the ``gpu`` backend."""
    if interpret is None:
        interpret = os.environ.get(INTERPRET_ENV, "") == "1"
        if not interpret and jax.default_backend() != "gpu":
            raise RuntimeError(
                f"Pallas kernels run compiled only on a GPU (backend is "
                f"{jax.default_backend()!r}); set {INTERPRET_ENV}=1 to run "
                "them in the Pallas interpreter instead")
    return bool(interpret)


def compiler_params() -> plgpu.CompilerParams:
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def pad_pow2(x: jnp.ndarray, multiple: int = 1) -> jnp.ndarray:
    """Zero-pad every axis of a small constant table to a power of two
    (at least ``multiple`` along the last axis)."""
    shape = list(x.shape)
    target = [next_pow2(s) for s in shape]
    target[-1] = max(target[-1], next_pow2(multiple))
    return jnp.pad(x, [(0, t - s) for s, t in zip(shape, target)])


def zero_partials(part_ref, n_rows: int, p_pad: int):
    """Zero this program's [1, n_rows, p_pad] partial-sum block."""
    z = jnp.zeros((PRIM_CHUNK,), _F32)

    def body(c, carry):
        for k in range(n_rows):
            part_ref[0, k, pl.ds(c * PRIM_CHUNK, PRIM_CHUNK)] = z
        return carry

    jax.lax.fori_loop(0, p_pad // PRIM_CHUNK, body, 0)


def accumulate_rows(part_ref, pc, hit, rows, p_total: int):
    """``part_ref[0, k, p] += sum(rows[k][lane] for lanes with hit and
    pc == p)`` for every row k: a one-hot sum over the program's lanes,
    taken PRIM_CHUNK primitives at a time over the range of indices the
    hit lanes name. Each program owns its block of ``part_ref``, so the
    sum is deterministic; the caller adds the blocks with ``jnp.sum``."""
    n = pc.shape[0]
    pmin = jnp.min(jnp.where(hit, pc, p_total - 1))
    pmax = jnp.max(jnp.where(hit, pc, 0))
    p_iota = jax.lax.broadcasted_iota(_I32, (PRIM_CHUNK, n), 0)
    pc_b = pc[None, :]
    hit_b = hit[None, :]

    def body(c, carry):
        sel = ((p_iota + c * PRIM_CHUNK) == pc_b) & hit_b
        sl = pl.ds(c * PRIM_CHUNK, PRIM_CHUNK)
        for k, r in enumerate(rows):
            part_ref[0, k, sl] = part_ref[0, k, sl] + jnp.sum(
                jnp.where(sel, r[None, :], 0.0), axis=1)
        return carry

    jax.lax.fori_loop(pmin // PRIM_CHUNK, pmax // PRIM_CHUNK + 1, body, 0)


def padded_prims(p: int) -> int:
    """Primitive-axis length of the backward kernels' tables and partial
    sums: a power of two and a whole number of PRIM_CHUNKs."""
    return max(next_pow2(p), PRIM_CHUNK)


def device_memory_bytes() -> int:
    """Memory this process's first local device offers (``bytes_limit`` of
    its memory stats; the host's physical memory where a device reports
    none, as the CPU does)."""
    stats = jax.local_devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
