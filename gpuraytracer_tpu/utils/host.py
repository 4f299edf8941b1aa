"""Device -> host readback (the analog of the reference's explicit
``getBytes`` readback, RTrace/image.swift:35-38)."""
from __future__ import annotations

import jax
import numpy as np


def fetch(x) -> np.ndarray:
    """Device array -> numpy."""
    return np.asarray(jax.device_get(x))


def fetch_tree(tree):
    return jax.device_get(tree)
