"""Every kernel lowers to Triton IR for the CUDA platform.

The card's compiler cannot be reached from a CPU-only machine, but the
Pallas Triton lowering (jaxpr -> Triton MLIR) runs anywhere: exporting
the entry points for ``platforms=["cuda"]`` with the compiled route
(``interpret=False``) catches unsupported primitives, non-power-of-two
loads and bad BlockSpecs before a kernel first meets the GPU."""
import jax
import jax.numpy as jnp
import pytest

from gpuraytracer_tpu.ops.pallas_mis import _render_mis_impl
from gpuraytracer_tpu.ops.pallas_mis_bwd import render_mis_fused
from gpuraytracer_tpu.ops.pallas_path import _render_pallas_impl
from gpuraytracer_tpu.ops.pallas_shade import render_path_decoupled_fused
from gpuraytracer_tpu.scene import (cornell_box, cornell_box_tessellated,
                                    cornell_box_with_spheres)
from gpuraytracer_tpu.types import RenderConfig

_TRITON_CALL = "__gpu$xla.gpu.triton"


def _lower_for_cuda(fn, *args):
    exp = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            _TRITON_CALL)])(*args)
    text = exp.mlir_module()
    assert _TRITON_CALL in text
    return text


_PATH = RenderConfig(width=16, height=16, integrator="path", spp=2,
                     bounces=2)
_MIS = RenderConfig(width=16, height=16, integrator="mis", camera_rays=1,
                    mis_samples=3)


def _scene(kind):
    if kind == "spheres":
        return cornell_box_with_spheres(resolution=(16, 16))
    if kind == "mesh":
        return cornell_box_tessellated(resolution=(16, 16), wall_subdiv=3,
                                       sphere_subdiv=0)
    return cornell_box(resolution=(16, 16))


@pytest.mark.parametrize("kind", ["box", "spheres", "mesh"])
def test_path_pair_lowers(kind):
    scene = _scene(kind)
    _lower_for_cuda(lambda s: _render_pallas_impl(s, _PATH,
                                                  interpret=False), scene)
    for records_only in (False, True):
        _lower_for_cuda(jax.grad(lambda s: jnp.mean(
            render_path_decoupled_fused(s, _PATH, interpret=False,
                                        records_only=records_only)),
            allow_int=True), scene)


@pytest.mark.parametrize("kind", ["box", "spheres", "mesh"])
def test_mis_pair_lowers(kind):
    scene = _scene(kind)
    _lower_for_cuda(lambda s: _render_mis_impl(s, _MIS, interpret=False),
                    scene)
    _lower_for_cuda(jax.grad(lambda s: jnp.mean(
        render_mis_fused(s, _MIS, interpret=False)), allow_int=True), scene)
