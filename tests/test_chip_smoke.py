"""chip_smoke.py's phases and checks at tiny size, with the kernels in the
Pallas interpreter (the script itself refuses any platform but ``gpu``)."""
import os

import jax
import numpy as np
import pytest

import chip_smoke
from gpuraytracer_tpu.scene import cornell_box, cornell_box_tessellated
from gpuraytracer_tpu.types import RenderConfig


def test_hdr_parity_counts_outliers():
    ref = np.full((10, 10, 3), 0.5, np.float32)
    k = ref.copy()
    k[0, 0] = 0.9                      # one flipped pixel
    st = chip_smoke.hdr_parity(k, ref)
    assert st["outliers"] == 1 and st["pixels"] == 100
    assert not chip_smoke.hdr_ok(st)   # 99% < 99.9%
    st = chip_smoke.hdr_parity(ref * (1 + 1e-6), ref)
    assert st["outliers"] == 0 and chip_smoke.hdr_ok(st)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.hdr_parity(np.full_like(ref, np.nan), ref)


def test_hdr_limit_follows_the_f32_oracle():
    """More outliers than 0.1% pass only where the float32 oracle itself
    has at least 1/F32_SLACK as many against the float64 reference."""
    assert chip_smoke.hdr_limit(262144) == 262
    f32 = {"outliers": 200}
    assert chip_smoke.hdr_limit(262144, f32) == 400
    st = {"pixels": 262144, "outliers": 300, "mean_rel": 0.0}
    assert chip_smoke.hdr_ok(st, f32) and not chip_smoke.hdr_ok(st)
    assert not chip_smoke.hdr_ok(dict(st, mean_rel=2e-4), f32)


def test_grad_parity_worst_leaf():
    go = {"a": np.ones(4, np.float32), "b": np.array([3.0, 4.0]),
          "i": np.arange(3)}
    gk = {"a": np.ones(4, np.float32), "b": np.array([3.0, 4.05]),
          "i": np.arange(3)}
    worst, leaf = chip_smoke.grad_parity(gk, go)
    assert worst == pytest.approx(0.05 / 5.0) and leaf == "['b']"
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.grad_parity({"a": np.ones(1), "b": np.ones(1)},
                               {"a": np.ones(1), "b": np.zeros(1)})


def test_grad_check_bar_per_leaf():
    """Each leaf within GRAD_RTOL of the float64 reference, or within
    F32_SLACK times the float32 oracle's own error on that leaf."""
    g64 = {"a": np.array([1.0, 0.0]), "b": np.array([0.0, 1.0])}
    g32 = {"a": np.array([1.0, 0.0]), "b": np.array([0.0, 1.01])}
    ok = {"a": np.array([1.0005, 0.0]), "b": np.array([0.0, 0.985])}
    r = chip_smoke.grad_check(ok, g32, g64)
    assert r["ok"] and r["bar"] == pytest.approx(0.02)
    bad = dict(ok, a=np.array([1.002, 0.0]))   # 2e-3 > GRAD_RTOL on "a"
    r = chip_smoke.grad_check(bad, g32, g64)
    assert not r["ok"] and r["leaf"] == "['a']"


def test_phase_cli_checks_at_tiny_size(tmp_path):
    """The CLI phase's checks on a tiny kernel-pair render: row count,
    finite rows, red left wall, green right wall."""
    from gpuraytracer_tpu import cli
    png, dbg = str(tmp_path / "p.png"), str(tmp_path / "p.txt")
    assert cli.main([png, "--kernel", "decoupled", "--width", "40",
                     "--height", "30", "--spp", "4",
                     "--debug-output", dbg]) == 0
    walls = chip_smoke.check_cli_outputs(png, dbg, 40, 30)
    assert walls["left_rgb"][0] > walls["left_rgb"][1]
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check_cli_outputs(png, dbg, 40, 31)


def test_phase_compile_and_parity_at_tiny_size(capsys):
    """Phases 2 and 3 on the 36-triangle box and a small tessellated box
    at 16x16: every job compiles (in parallel threads), the float64 oracle
    jobs run with 64-bit types, and every comparison passes."""
    cfg_path = RenderConfig(width=16, height=16, integrator="path", spp=1,
                            bounces=1)
    cfg_mis = RenderConfig(width=16, height=16, integrator="mis",
                           camera_rays=1, mis_samples=3)
    scenes = {"box36": cornell_box(resolution=(16, 16)),
              "mesh1002": cornell_box_tessellated(
                  resolution=(16, 16), wall_subdiv=2, sphere_subdiv=0)}
    compiled = chip_smoke.compile_all(chip_smoke.parity_jobs(
        cfg_path, cfg_mis, scenes, cfg_mis,
        {"path": cfg_path, "mis": cfg_mis}, scenes), threads=4)
    assert len(compiled) == 22
    exe, args = compiled["path_o64/box36"]
    assert exe(*args)[0].dtype == np.float64
    chip_smoke.phase_parity(compiled, {})
    out = capsys.readouterr().out
    assert out.count("[compile] name=") == 22
    assert out.count("[parity]") == 8 + 4
    assert out.count(" leaf=") == 4


def test_phase_four_on_virtual_devices(capsys):
    """The --four phase at tiny size on four virtual CPU devices: sharded
    images bit-identical to one device, gradients and training-step
    losses within tolerance."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four(
        4, RenderConfig(width=16, height=16, integrator="path", spp=1,
                        bounces=1),
        RenderConfig(width=16, height=16, integrator="mis", camera_rays=1,
                     mis_samples=3))
    out = capsys.readouterr().out
    assert out.count("hdr_bit_identical=True") == 2
    assert out.count("train_step=") == 3


def test_phase_device_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(chip_smoke.PhaseError, match="platform"):
        chip_smoke.phase_device(1)


def test_main_refuses_non_gpu_platform(capsys):
    """On the CPU the script exits non-zero and prints no result line."""
    assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_main_refuses_without_package(monkeypatch, capsys):
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "gpuraytracer_tpu" else real(name,
                                                                     *a))
    assert chip_smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out
