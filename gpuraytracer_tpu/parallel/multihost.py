"""Multi-host runtime (SURVEY.md §2.4, §5 "Distributed communication
backend").

The reference is a single process that aborts on any failure
(RTrace/renderer.swift:33-41); multi-host execution works as follows:
``jax.distributed.initialize`` brings up the JAX runtime across hosts, each
host computes its shard of the pixel batch through the same
``shard_map``-based renderer (parallel/mesh.py), and host 0 materializes the
full image for I/O via ``process_allgather``.

All of this degrades gracefully to a single process: ``init_distributed`` is
a no-op when no coordinator is configured, and ``gather_image`` returns the
local (fully-addressable) array as-is.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize the multi-host JAX runtime.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) so cluster
    launchers can configure hosts uniformly. Returns True if distributed mode
    was initialized, False for single-process operation."""
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not coordinator_address:
        return False
    kwargs = dict(coordinator_address=coordinator_address)
    num_processes = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else os.environ.get("JAX_PROCESS_ID")
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    jax.distributed.initialize(**kwargs)
    return True


def is_primary() -> bool:
    """True on the host that should perform I/O (process 0)."""
    return jax.process_index() == 0


def gather_image(x) -> np.ndarray:
    """Materialize a (possibly cross-host sharded) array on every host.

    For single-host arrays this is a plain device->host fetch; for
    multi-host global arrays it all-gathers the shards over DCN
    (``process_allgather``), so host 0 can write the PNG."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def sync_hosts(name: str = "barrier") -> None:
    """Cross-host barrier (used around checkpoint save/restore)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
