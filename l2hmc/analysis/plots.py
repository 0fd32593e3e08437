"""Plot families for training/eval runs.

Rebuild of the reference plotting suite (``utils/plot_helper.py:23-274``,
``gauge_model.py:1462-1737``): observable-vs-step traces with exact-value
reference lines, topological-charge tunneling events, charge histograms,
autocorrelation curves, and the annealing schedule.  Matplotlib Agg backend;
every function writes a PNG and returns its path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from l2hmc.analysis import stats  # noqa: E402


def _save(fig, out_file: str | Path) -> Path:
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_file, dpi=120)
    plt.close(fig)
    return out_file


def plot_observable(
    trace: np.ndarray,
    name: str,
    out_file: str | Path,
    exact: Optional[float] = None,
    therm_frac: float = 0.25,
) -> Path:
    """Observable vs step (chain mean ± spread) with the analytic anchor
    line the reference prints next to every table row."""
    trace = np.asarray(trace)
    t = np.arange(len(trace))
    fig, ax = plt.subplots(figsize=(7, 3.2))
    if trace.ndim > 1:
        mean = trace.reshape(len(trace), -1).mean(axis=1)
        lo = np.percentile(trace.reshape(len(trace), -1), 16, axis=1)
        hi = np.percentile(trace.reshape(len(trace), -1), 84, axis=1)
        ax.fill_between(t, lo, hi, alpha=0.25, lw=0)
    else:
        mean = trace
    ax.plot(t, mean, lw=1)
    if exact is not None:
        ax.axhline(exact, color="k", ls="--", lw=1, label=f"exact {exact:.5f}")
        ax.legend(frameon=False)
    cut = int(len(trace) * therm_frac)
    if cut:
        ax.axvline(cut, color="gray", ls=":", lw=1)
    ax.set_xlabel("step")
    ax.set_ylabel(name)
    return _save(fig, out_file)


def plot_charges(charges: np.ndarray, out_file: str | Path, max_chains: int = 8) -> Path:
    """Topological charge trajectories (tunneling events visible as jumps)."""
    charges = np.asarray(charges)
    fig, ax = plt.subplots(figsize=(7, 3.2))
    flat = charges.reshape(len(charges), -1)
    for c in range(min(flat.shape[1], max_chains)):
        ax.plot(flat[:, c], lw=0.8, alpha=0.8, drawstyle="steps-mid")
    ax.set_xlabel("step")
    ax.set_ylabel("topological charge Q")
    return _save(fig, out_file)


def plot_charge_histogram(charges: np.ndarray, out_file: str | Path) -> Path:
    q = np.asarray(charges).astype(int).ravel()
    vals, counts = np.unique(q, return_counts=True)
    fig, ax = plt.subplots(figsize=(4.5, 3.2))
    ax.bar(vals, counts / counts.sum(), width=0.8)
    ax.set_xlabel("Q")
    ax.set_ylabel("probability")
    return _save(fig, out_file)


def plot_autocorrelation(
    trace: np.ndarray, out_file: str | Path, max_lag: int = 200
) -> Path:
    trace = np.asarray(trace)
    if trace.ndim > 1:
        trace = trace.reshape(len(trace), -1).mean(axis=1)
    rho = stats.autocorr_fft(trace)[:max_lag]
    fig, ax = plt.subplots(figsize=(4.5, 3.2))
    ax.plot(rho, lw=1)
    ax.axhline(0, color="k", lw=0.5)
    tau, _ = stats.integrated_time(trace)
    ax.set_title(f"tau_int = {tau:.1f}")
    ax.set_xlabel("lag")
    ax.set_ylabel("autocorrelation")
    return _save(fig, out_file)


def plot_schedule(values: np.ndarray, name: str, out_file: str | Path) -> Path:
    """Annealing schedule (beta or temperature) vs step
    (``utils/plot_helper.py`` annealing plots)."""
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(np.asarray(values), lw=1)
    ax.set_xlabel("step")
    ax.set_ylabel(name)
    return _save(fig, out_file)


def make_run_plots(run_dir: str | Path, exact_plaq: Optional[float] = None) -> list:
    """All plot families for a run dir (training metrics + eval traces) —
    the ``make_plots`` entry of ``gauge_model.py:1462-1470``."""
    from l2hmc.analysis.observables import load_run

    run_dir = Path(run_dir)
    data = load_run(run_dir)
    written = []
    plots = run_dir / "plots"
    m = data["metrics"]
    for name in ("loss", "accept_prob", "plaqs", "eps"):
        if name in m and np.issubdtype(np.asarray(m[name]).dtype, np.number):
            exact = exact_plaq if name == "plaqs" else None
            written.append(
                plot_observable(m[name], name, plots / f"train_{name}.png", exact)
            )
    if "beta" in m:
        written.append(plot_schedule(m["beta"], "beta", plots / "train_beta.png"))
    for ev_name, traces in data["evals"].items():
        for name, arr in traces.items():
            if name == "charges":
                written.append(plot_charges(arr, plots / f"{ev_name}_charges.png"))
                written.append(
                    plot_charge_histogram(arr, plots / f"{ev_name}_charge_hist.png")
                )
            else:
                written.append(
                    plot_observable(arr, name, plots / f"{ev_name}_{name}.png")
                )
            if name == "plaqs":
                written.append(
                    plot_autocorrelation(arr, plots / f"{ev_name}_plaqs_autocorr.png")
                )
    return written
