"""Offline re-analysis + plots pipeline tests (synthetic run dir)."""

import json
from pathlib import Path

import numpy as np
import pytest

from l2hmc.analysis.observables import (
    analyze_observable_traces,
    analyze_run,
    load_run,
    thermalization_step,
)


@pytest.fixture
def run_dir(tmp_path):
    rng = np.random.default_rng(0)
    # metrics.jsonl
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for step in range(10):
            f.write(json.dumps({"step": step * 50, "loss": -10.0 - step,
                                "plaqs": 0.6 + 0.001 * step}) + "\n")
    # eval traces: 400 steps x 8 chains
    t = 400
    plaqs = 0.68 + 0.01 * rng.standard_normal((t, 8))
    plaqs[:50] -= np.linspace(0.2, 0.0, 50)[:, None]  # thermalization ramp
    charges = rng.integers(-2, 3, (t, 8)).astype(float)
    accept = rng.uniform(0.4, 0.9, (t, 8))
    np.savez_compressed(tmp_path / "eval_beta2.npz", plaqs=plaqs,
                        charges=charges, accept_prob=accept)
    return tmp_path


def test_load_run(run_dir):
    data = load_run(run_dir)
    assert data["metrics"]["loss"].shape == (10,)
    assert "eval_beta2" in data["evals"]
    assert data["evals"]["eval_beta2"]["plaqs"].shape == (400, 8)


def test_analyze_traces(run_dir):
    data = load_run(run_dir)
    out = analyze_observable_traces(data["evals"]["eval_beta2"])
    assert abs(out["plaqs"]["mean"] - 0.68) < 0.01
    assert out["plaqs"]["jackknife_err"] > 0
    assert 0 < out["plaqs"]["ess_per_sample"] <= 1.5
    assert "histogram" in out["charges"]
    assert out["charges"]["susceptibility"] > 0
    assert out["charges"]["tunneling_rate"] > 0
    # pooled multi-chain estimators ship next to the single-trace numbers
    # iid-ish synthetic data -> tau_pooled ~ 1
    assert out["charges"]["tau_int_pooled"] == pytest.approx(1.0, abs=0.5)
    assert out["charges"]["tau_int_pooled_reliable"] is True
    assert 0 < out["charges"]["ess_per_sample_pooled"] <= 1.0


def test_thermalization_step(run_dir):
    data = load_run(run_dir)
    step = thermalization_step(data["evals"]["eval_beta2"]["plaqs"])
    assert 0 < step <= 200


def test_analyze_run_writes_json(run_dir):
    report = analyze_run(run_dir)
    f = run_dir / "analysis.json"
    assert f.exists()
    loaded = json.loads(f.read_text())
    assert "eval_beta2" in loaded
    assert loaded["training"]["loss"]["final"] == -19.0


def test_plots(run_dir):
    from l2hmc.analysis.plots import make_run_plots

    written = make_run_plots(run_dir, exact_plaq=0.6978)
    assert len(written) >= 5
    for p in written:
        assert Path(p).exists() and Path(p).stat().st_size > 1000
