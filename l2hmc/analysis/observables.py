"""Offline observables re-analysis pipeline.

Rebuild of ``utils/gauge_observables.py:44-1172``: given a run directory
(metrics.jsonl + eval npz files written by the trainer/CLI), recompute
plaquette / topological-susceptibility statistics with jackknife errors,
charge histograms and tunneling events, autocorrelation / IAT / ESS of the
observables, thermalization estimates, and write a summary JSON + plots.

The reference reconstructs the lattice and recomputes observables from
pickled *samples* (``:263-325``); our eval path already persists the
observable traces (samples optional via ``--save_samples``), so re-analysis
is pure statistics — no device needed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from l2hmc.analysis import stats


def analyze_observable_traces(
    traces: Dict[str, np.ndarray],
    therm_frac: float = 0.25,
    num_blocks: int = 10,
) -> Dict:
    """Full statistics for eval traces shaped ``(T, chains)``.

    Returns per-observable {mean, sem, jackknife mean/err, tau_int, ess};
    for charges additionally the histogram, susceptibility <Q^2>, and the
    tunneling rate <|dQ|>.
    """
    out = {}
    for name, arr in traces.items():
        arr = np.asarray(arr)
        cut = stats.therm_cut(arr, therm_frac)
        flat = cut.reshape(len(cut), -1)
        chain_mean = flat.mean(axis=1)
        jk_mean, jk_err = stats.jackknife(chain_mean, num_blocks)
        tau, reliable = stats.integrated_time(chain_mean)
        ess = float(np.mean([
            stats.calc_ess(flat[:, c]) for c in range(min(flat.shape[1], 16))
        ]))
        # pooled multi-chain estimator next to the single-trace Sokal
        # number: per-chain windows are
        # noise at large tau; pooling C chains extends the reliable range
        # ~C-fold (analysis/stats.py pooled_integrated_time)
        tau_p, reliable_p = stats.pooled_integrated_time(flat)
        out[name] = {
            "mean": float(flat.mean()),
            "sem": stats.sem(chain_mean),
            "jackknife_mean": jk_mean,
            "jackknife_err": jk_err,
            "tau_int": tau,
            "tau_int_reliable": reliable,
            "ess_per_sample": ess,
            "tau_int_pooled": tau_p,
            "tau_int_pooled_reliable": reliable_p,
            "ess_per_sample_pooled": float(1.0 / max(tau_p, 1.0)),
        }
    if "charges" in traces:
        q = stats.therm_cut(np.asarray(traces["charges"]), therm_frac)
        dq = stats.tunneling_events(q)
        out["charges"].update(
            histogram={str(k): v for k, v in stats.charge_histogram(q).items()},
            susceptibility=float(np.mean(q * q)),
            tunneling_rate=float(dq.mean()),
        )
    return out


def thermalization_step(arr: np.ndarray, window: int = 20) -> int:
    """Estimate the thermalization step as the first window whose mean is
    within 2 sem of the final-half mean (``gauge_observables.py:597``-ish)."""
    arr = np.asarray(arr)
    if arr.ndim > 1:
        arr = arr.reshape(len(arr), -1).mean(axis=1)
    target = arr[len(arr) // 2 :].mean()
    spread = 2 * (arr[len(arr) // 2 :].std() + 1e-12)
    for i in range(0, len(arr) - window, window):
        if abs(arr[i : i + window].mean() - target) < spread:
            return i
    return len(arr) // 2


def load_run(run_dir: str | Path) -> Dict:
    """Load a run directory: metrics.jsonl -> dict of arrays, eval npz files."""
    run_dir = Path(run_dir)
    out = {"metrics": {}, "evals": {}}
    mfile = run_dir / "metrics.jsonl"
    if mfile.exists():
        recs = [json.loads(l) for l in mfile.read_text().splitlines() if l.strip()]
        if recs:
            keys = set().union(*(r.keys() for r in recs))
            out["metrics"] = {
                k: np.array([r.get(k, np.nan) for r in recs]) for k in keys
            }
    for npz in sorted(run_dir.glob("eval_*.npz")):
        with np.load(npz) as data:
            out["evals"][npz.stem] = {k: data[k] for k in data.files}
    return out


def analyze_run(run_dir: str | Path, therm_frac: float = 0.25) -> Dict:
    """Re-analyze a run dir; writes ``analysis.json`` next to the inputs."""
    run_dir = Path(run_dir)
    data = load_run(run_dir)
    report: Dict = {"run_dir": str(run_dir)}
    if data["metrics"]:
        m = data["metrics"]
        report["training"] = {
            k: {"final": float(np.asarray(v)[-1])}
            for k, v in m.items()
            if np.issubdtype(np.asarray(v).dtype, np.number)
        }
    for name, traces in data["evals"].items():
        report[name] = analyze_observable_traces(traces, therm_frac)
        if "plaqs" in traces:
            report[name]["thermalization_step"] = thermalization_step(traces["plaqs"])
    (run_dir / "analysis.json").write_text(json.dumps(report, indent=2, default=str))
    return report
