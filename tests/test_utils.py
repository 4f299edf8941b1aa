"""Checkpoint/resume, metrics, host helpers."""
import numpy as np
import pytest

from gpuraytracer_tpu.scene import cornell_box
from gpuraytracer_tpu.types import RenderConfig
from gpuraytracer_tpu.utils import checkpoint as ckpt
from gpuraytracer_tpu.utils.metrics import (MetricLogger, mrays_per_s,
                                            nominal_rays, timed)


@pytest.fixture(scope="module")
def scene():
    return cornell_box(resolution=(16, 16))


def _cfg(**kw):
    base = dict(width=16, height=16, integrator="path", spp=4, bounces=2,
                pixel_chunk=256)
    base.update(kw)
    return RenderConfig(**base)


def test_progressive_accumulation_matches_mc_statistics(scene):
    """Accumulating 2x4 spp across steps gives the sample mean of the union
    of the two sample sets (different seeds per step)."""
    cfg = _cfg()
    acc = ckpt.init_accumulator(cfg)
    acc = ckpt.accumulate(scene, cfg, acc, 4)
    acc = ckpt.accumulate(scene, cfg, acc, 4)
    assert int(acc.spp_done) == 8
    img = np.asarray(ckpt.resolve(acc))
    assert img.shape == (16, 16, 3)
    assert np.all(np.isfinite(img))
    # The two steps used different seeds => not just the first step repeated.
    from gpuraytracer_tpu.render import render
    single = np.asarray(render(scene, cfg).hdr)
    assert not np.array_equal(img, single)


def test_progressive_fused_kernel_matches_oracle_and_resumes(scene, tmp_path):
    """Kernel-speed progressive rendering (VERDICT r3 #5): accumulating two
    batches through the FUSED path equals the oracle accumulation of the
    same two seeded sample batches, and a save/load between the batches
    changes nothing."""
    cfg = _cfg(spp=2)
    # Oracle accumulation of batches (seed, seed+1).
    acc_o = ckpt.init_accumulator(cfg)
    acc_o = ckpt.accumulate(scene, cfg, acc_o, 2, kernel="jnp")
    acc_o = ckpt.accumulate(scene, cfg, acc_o, 2, kernel="jnp")
    # Fused accumulation with a checkpoint/resume between the batches.
    acc_f = ckpt.init_accumulator(cfg)
    acc_f = ckpt.accumulate(scene, cfg, acc_f, 2, kernel="decoupled")
    path = str(tmp_path / "acc_fused.npz")
    ckpt.save_accumulator(path, acc_f, cfg)
    acc_f = ckpt.load_accumulator(path, cfg)
    acc_f = ckpt.accumulate(scene, cfg, acc_f, 2, kernel="decoupled")
    assert int(acc_f.spp_done) == int(acc_o.spp_done) == 4
    np.testing.assert_allclose(np.asarray(ckpt.resolve(acc_f)),
                               np.asarray(ckpt.resolve(acc_o)),
                               atol=2e-5, rtol=1e-4)


def test_checkpoint_roundtrip(scene, tmp_path):
    cfg = _cfg()
    acc = ckpt.accumulate(scene, cfg, ckpt.init_accumulator(cfg), 4)
    path = str(tmp_path / "acc.npz")
    ckpt.save_accumulator(path, acc, cfg)
    back = ckpt.load_accumulator(path, cfg)
    np.testing.assert_array_equal(np.asarray(back.radiance_sum),
                                  np.asarray(acc.radiance_sum))
    assert int(back.spp_done) == 4
    # Resume: render 4 more on the restored state.
    resumed = ckpt.accumulate(scene, cfg, back, 4)
    assert int(resumed.spp_done) == 8


def test_checkpoint_config_mismatch(scene, tmp_path):
    cfg = _cfg()
    acc = ckpt.init_accumulator(cfg)
    path = str(tmp_path / "acc.npz")
    ckpt.save_accumulator(path, acc, cfg)
    with pytest.raises(ValueError):
        ckpt.load_accumulator(path, _cfg(width=32))


def test_nominal_rays():
    assert nominal_rays(_cfg()) == 16 * 16 * 4 * 2 * 2
    assert nominal_rays(_cfg(integrator="direct")) == 16 * 16 * 4 * 2
    mis = _cfg(integrator="mis", camera_rays=2, mis_samples=30)
    assert nominal_rays(mis) == 16 * 16 * 2 * (1 + 60)
    assert mrays_per_s(_cfg(), 1.0) == pytest.approx(
        nominal_rays(_cfg()) / 1e6)


def test_metric_logger(tmp_path):
    log = MetricLogger(path=str(tmp_path / "metrics.jsonl"))
    with timed(log, "block", phase="test"):
        pass
    log.log("custom", 42, unit="count")
    lines = open(tmp_path / "metrics.jsonl").read().strip().splitlines()
    assert len(lines) == 2
    import json
    rec = json.loads(lines[1])
    assert rec["metric"] == "custom" and rec["value"] == 42


def test_fetch_helper(scene):
    import jax.numpy as jnp
    from gpuraytracer_tpu.utils.host import fetch, fetch_tree
    x = jnp.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(fetch(x), np.arange(12.0).reshape(3, 4))
    tree = {"a": x, "b": jnp.ones(2)}
    out = fetch_tree(tree)
    assert isinstance(out["a"], np.ndarray)


def test_debug_checks_restores_config():
    import jax
    from gpuraytracer_tpu.utils.debug import debug_checks
    import jax.numpy as jnp
    assert not jax.config.jax_debug_nans
    with debug_checks(nans=True, infs=True):
        assert jax.config.jax_debug_nans
        assert jax.config.jax_debug_infs
        # a clean computation passes under the checks
        assert float(jnp.sum(jnp.ones(4))) == 4.0
    assert not jax.config.jax_debug_nans
    assert not jax.config.jax_debug_infs


def test_debug_checks_catches_nan():
    import jax.numpy as jnp
    import pytest as _pytest
    from gpuraytracer_tpu.utils.debug import debug_checks
    with debug_checks(nans=True):
        with _pytest.raises(FloatingPointError):
            float(jnp.log(jnp.zeros(2) - 1.0).sum())


def test_roofline_model_sane():
    from gpuraytracer_tpu.utils.metrics import roofline, roofline_pct
    kind = "NVIDIA H100 80GB HBM3"
    compute = roofline(67e12, 1.0, kind)      # 1 s of f32 work, ~no bytes
    assert compute["bound"] == "compute"
    assert compute["t_floor_s"] == _pytest_approx(1.0)
    memory = roofline(1.0, 3.35e12, kind)     # 1 s of HBM traffic
    assert memory["bound"] == "memory"
    # achieved% is monotone in measured time and 100 at the floor
    assert roofline_pct(compute["t_floor_s"], compute) == \
        _pytest_approx(100.0)
    assert roofline_pct(2 * compute["t_floor_s"], compute) == \
        _pytest_approx(50.0)


def test_peaks_table_has_h100():
    from gpuraytracer_tpu.utils.metrics import peaks
    pk = peaks("NVIDIA H100 80GB HBM3")
    assert pk["f32_flops_per_s"] == 67e12
    assert pk["hbm_bytes_per_s"] == 3.35e12


def test_peaks_table_unknown_device_raises():
    from gpuraytracer_tpu.utils.metrics import peaks, roofline
    with pytest.raises(KeyError, match="no published peaks"):
        peaks("cpu")
    with pytest.raises(KeyError):
        roofline(1.0, 1.0, "some other accelerator")


def _pytest_approx(x):
    return pytest.approx(x, rel=1e-6)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    from gpuraytracer_tpu.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch):
    import os
    from gpuraytracer_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == cache.DEFAULT_CACHE_DIR
    assert os.path.basename(cache.DEFAULT_CACHE_DIR) == ".jax_cache"
