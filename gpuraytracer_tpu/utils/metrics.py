"""Observability: structured metrics, rays/s accounting, render timing.

The reference's only observability is print statements + a per-pixel debug
buffer (SURVEY.md §5). Here: a structured metric logger (JSON lines), the
nominal-ray accounting used by bench.py, a timing context, and the devices'
published peaks for roofline shares."""
from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..types import RenderConfig


def nominal_rays(config: RenderConfig) -> int:
    """Rays per frame as executed by the fixed-shape kernels: every
    (pixel, sample, bounce) computes one closest-hit and one shadow query
    regardless of liveness. For the MIS integrator: camera rays x (1 camera
    trace + per-MIS-sample primary + secondary NEE traces)."""
    if config.integrator in ("path", "direct"):
        bounces = 1 if config.integrator == "direct" else config.bounces
        return config.num_pixels * config.spp * bounces * 2
    if config.integrator == "mis":
        per_sample = 2  # strategy trace + (secondary NEE or light check)
        return (config.num_pixels * config.camera_rays
                * (1 + config.mis_samples * per_sample))
    raise ValueError(config.integrator)


def mrays_per_s(config: RenderConfig, seconds: float) -> float:
    return nominal_rays(config) / seconds / 1e6


@dataclass
class MetricLogger:
    """JSON-lines metric sink (stdout or file)."""

    path: Optional[str] = None
    records: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, name: str, value: Any, **tags: Any) -> None:
        rec = {"metric": name, "value": value, "time": time.time(), **tags}
        self.records.append(rec)
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        else:
            print(line, file=sys.stderr)


@contextmanager
def timed(logger: Optional[MetricLogger], name: str, **tags: Any):
    """Wall-clock a block; caller is responsible for fencing device work
    (fetch a scalar or block_until_ready on a trusted transport)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log(name, dt, unit="s", **tags)


@contextmanager
def profiler_trace(log_dir: str):
    """jax.profiler trace for TensorBoard/perfetto (SURVEY.md §5 tracing
    plan)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# ---------------------------------------------------------------------------
# Roofline: the least time the device could take for a given operation and
# byte count, from its published peaks.
# ---------------------------------------------------------------------------

# Published peaks keyed by ``jax.devices()[0].device_kind``. H100 SXM: NVIDIA
# H100 Tensor Core GPU data sheet (dense rates, 700 W): 67 TFLOP/s f32
# outside the tensor cores, 3.35 TB/s HBM3. Intersection and shading are f32
# elementwise work, so the f32 rate (not the tensor cores) bounds compute.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    """Published peaks of a device; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r};"
                       " add its data-sheet figures to metrics.PEAKS") \
            from None


def roofline(flops: float, bytes_moved: float, device_kind: str) -> dict:
    """Time floors for ``flops`` f32 operations and ``bytes_moved`` bytes
    of device-memory traffic, and which of the two bounds the work."""
    pk = peaks(device_kind)
    t_flops = flops / pk["f32_flops_per_s"]
    t_bytes = bytes_moved / pk["hbm_bytes_per_s"]
    return {"t_flops_s": t_flops, "t_bytes_s": t_bytes,
            "t_floor_s": max(t_flops, t_bytes),
            "bound": "compute" if t_flops >= t_bytes else "memory"}


def roofline_pct(measured_s: float, model: dict) -> float:
    """Achieved share of the roofline floor, in percent."""
    return 100.0 * model["t_floor_s"] / measured_s
