"""chip_smoke.py's phases at tiny sizes on the CPU. The script itself
refuses the CPU, so its phase functions are imported and called here."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


class InProcessReference:
    """Stands in for the CPU child: computes its values in this process
    (the test session runs on the CPU with x64 enabled)."""

    def __init__(self, n_samples=16, seed=0, small=(8, 300)):
        self.args = (n_samples, seed, small)

    def get(self, key):
        n, seed, small = self.args
        if key == "solvers_f32":
            return chip_smoke.solver_recoveries(n, seed, np.float32)
        if key == "solvers_f64":
            return chip_smoke.solver_recoveries(n, seed, np.float64)
        if key == "small_ba_f64":
            return chip_smoke.small_ba_costs(*small, dtype=np.float64)
        raise KeyError(key)


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "no GPU" in err


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device(monkeypatch, capsys):
    from pytheiasfm_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_persistent_cache", lambda: "/cache")
    out = chip_smoke.phase_device()
    assert out["matmul_precision"] == "float32"
    assert out["compile_cache"] == "/cache"
    assert out["backend"] == "cpu"
    assert capsys.readouterr().out.startswith("phase device: ")


def test_solver_samples_are_consistent():
    x1, x2, R, t, E_gt, pts = chip_smoke.solver_samples(4, 5, seed=1)
    h1 = np.concatenate([x1, np.ones((4, 5, 1))], -1)
    h2 = np.concatenate([x2, np.ones((4, 5, 1))], -1)
    resid = np.einsum("bni,bij,bnj->bn", h2, E_gt, h1)
    assert np.abs(resid).max() < 1e-12
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.tile(np.eye(3), (4, 1, 1)), atol=1e-12)


def test_phase_minimal_solvers(capsys):
    out = chip_smoke.phase_minimal_solvers(InProcessReference(16), n=16)
    assert out["cpu_f64"]["five_point"] >= 14
    assert out["cpu_f64"]["p3p"] >= 15
    # On the CPU the "device" run is the CPU f32 run itself.
    assert out["device_f32"] == out["cpu_f32"]
    assert "phase minimal_solvers:" in capsys.readouterr().out


def test_phase_minimal_solvers_fails_below_margin(monkeypatch):
    monkeypatch.setattr(
        chip_smoke, "solver_recoveries",
        lambda n, seed, dtype: {"five_point": 0, "p3p": 16, "samples": n},
    )

    class Ref:
        def get(self, key):
            return {"five_point": 15, "p3p": 16, "samples": 16}

    with pytest.raises(AssertionError, match="five_point"):
        chip_smoke.phase_minimal_solvers(Ref(), n=16)


def test_noise_floor():
    prob = dict(
        obs_mask=np.array([True] * 90 + [False] * 10),
        camera_free=np.array([False, False, True]),
        T=10,
    )
    # 0.5 * 0.25 * (2 * 90 - 6 - 30)
    assert chip_smoke.noise_floor(prob) == pytest.approx(18.0)


def test_phase_bundle_adjustment_small(capsys):
    out = chip_smoke.phase_bundle_adjustment(
        InProcessReference(small=(8, 300)), V=16, T=1_500, small=(8, 300)
    )
    assert out["dense_final_cost"] < out["dense_initial_cost"]
    assert abs(out["recovered_focal"] - 1000.0) < 1.0
    assert "phase bundle_adjustment:" in capsys.readouterr().out


def test_phase_global_pipeline_small(capsys):
    out = chip_smoke.phase_global_pipeline(V=40, T=3_000, cpu_median=0.05)
    assert out["views"] == 40
    assert out["t_total_s"] > 0
    assert "phase global_pipeline:" in capsys.readouterr().out


def test_phase_verify_reconstruct_small(capsys):
    out = chip_smoke.phase_verify_reconstruct(num_views=11, num_tracks=250)
    assert out["cameras"] == 11
    assert out["edges"] > 11
    assert "phase verify_reconstruct:" in capsys.readouterr().out


def test_phase_matcher_small(capsys):
    out = chip_smoke.phase_matcher(n_desc=128, dim=32, pairs=2, reps=2)
    assert out["choice"] == {"matcher_xla": 1}
    assert out["match_agreement"] >= 0.99
    assert out["padded_dim"]["shape"] == [2, 128, 40]
    assert out["padded_dim"]["match_agreement"] >= 0.99
    assert out["kernel_pairs_per_s"] > 0 and out["xla_pairs_per_s"] > 0
    assert "phase matcher:" in capsys.readouterr().out


def test_padded_matcher_inputs():
    d1, d2, m1, m2, perm = chip_smoke.padded_matcher_inputs(128, 40, 2, 0)
    assert d1.shape == d2.shape == (2, 128, 40)
    assert m1[:, :-7].all() and not m1[:, -7:].any()
    assert m2[:, :-3].all() and not m2[:, -3:].any()
    assert not d1[~m1].any() and not d2[~m2].any()
    assert sorted(perm[0]) == list(range(128))


def test_matcher_parity_checks_the_choice():
    args = chip_smoke.padded_matcher_inputs(128, 32, 2, 0)
    with pytest.raises(AssertionError, match="auto matcher chose"):
        chip_smoke.matcher_parity(*args, expected="triton")


def test_cpu_reference_child():
    """The real child process, at tiny sizes: `collect` reads every
    value and sees the child exit 0."""
    ref = chip_smoke.CpuReference(seed=0, n_samples=8, small_ba=(8, 300))
    try:
        ref.collect()
    finally:
        ref.close()
    f32 = ref.get("solvers_f32")
    f64 = ref.get("solvers_f64")
    small = ref.get("small_ba_f64")
    assert f32["samples"] == f64["samples"] == 8
    assert f64["p3p"] >= 7
    assert set(small) == {"dense", "free"}
    assert all(np.isfinite(v) and v > 0 for v in small.values())
    assert ref.proc.returncode == 0
