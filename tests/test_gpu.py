"""Card-only tests: the compiled Triton kernels on the GPU. Marked ``gpu``;
they skip without a card and run through ``python chip_smoke.py`` on one
(chip_smoke.py itself checks every kernel against the oracle at full
width)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer_tpu.ops.pallas_shade import render_path_decoupled_fused
from gpuraytracer_tpu.render import render_path
from gpuraytracer_tpu.scene import cornell_box
from gpuraytracer_tpu.types import RenderConfig

pytestmark = pytest.mark.gpu

_PATH = RenderConfig(width=32, height=32, integrator="path", spp=2,
                     bounces=3)


def test_path_pair_compiled_matches_oracle(gpu_device):
    """Trace kernel + hand-written backward, compiled for the card, against
    the jnp oracle and its AD at a tiny size."""
    scene = cornell_box(resolution=(32, 32))

    def vg(render):
        return jax.jit(jax.value_and_grad(
            lambda s: jnp.mean(render(s) ** 2), allow_int=True))

    with jax.default_matmul_precision("highest"):
        v_k, g_k = vg(lambda s: render_path_decoupled_fused(
            s, _PATH, interpret=False))(scene)
        v_o, g_o = vg(lambda s: render_path(s, _PATH).hdr)(scene)
    np.testing.assert_allclose(float(v_k), float(v_o), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(g_k), jax.tree.leaves(g_o)):
        b = np.asarray(b)
        if np.issubdtype(b.dtype, np.floating) and b.size:
            assert np.linalg.norm(np.asarray(a) - b) <= \
                1e-3 * np.linalg.norm(b) + 1e-12


def test_device_has_published_peaks(gpu_device):
    from gpuraytracer_tpu.utils.metrics import peaks
    assert peaks(gpu_device.device_kind)["f32_flops_per_s"] > 0
