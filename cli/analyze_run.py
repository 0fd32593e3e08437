#!/usr/bin/env python
"""Offline re-analysis CLI — the ``utils/gauge_observables.py`` pipeline.

Usage:
    python cli/analyze_run.py runs/gauge/run_1 [--therm_frac 0.25] [--plots]

Reads metrics.jsonl and eval_*.npz from the run dir, writes analysis.json
(jackknife stats, IAT/ESS, charge histograms, tunneling rates) and, with
--plots, the full plot families under <run_dir>/plots/.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("--therm_frac", type=float, default=0.25)
    p.add_argument("--plots", action="store_true")
    p.add_argument("--beta", type=float, default=None,
                   help="beta for the exact-plaquette reference line")
    args = p.parse_args(argv)

    from l2hmc.analysis.observables import analyze_run
    from l2hmc.analysis.plots import make_run_plots

    report = analyze_run(args.run_dir, args.therm_frac)
    print(f"wrote {Path(args.run_dir) / 'analysis.json'}")
    for name, section in report.items():
        if (
            isinstance(section, dict)
            and isinstance(section.get("plaqs"), dict)
            and "jackknife_mean" in section["plaqs"]
        ):
            pl = section["plaqs"]
            print(
                f"{name}: plaq = {pl['jackknife_mean']:.5f} "
                f"+- {pl['jackknife_err']:.5f} (tau_int {pl['tau_int']:.1f})"
            )
            if "charges" in section:
                ch = section["charges"]
                rel = "" if ch.get("tau_int_pooled_reliable") else \
                    " [unreliable: window exceeds trace]"
                print(
                    f"{name}: <Q^2> = {ch['susceptibility']:.3f} "
                    f"tunneling <|dQ|> = {ch['tunneling_rate']:.3f} "
                    f"tau_int(Q) sokal = {ch['tau_int']:.1f}, "
                    f"pooled = {ch['tau_int_pooled']:.1f}{rel}"
                )
            if "hop_accept" in section:
                print(
                    f"{name}: hop_accept = "
                    f"{section['hop_accept']['mean']:.4f} "
                    f"hop_dq = {section['hop_dq']['mean']:.4f}"
                )

    if args.plots:
        exact = None
        if args.beta is not None:
            from l2hmc.lattice import u1

            exact = float(u1.u1_plaq_exact(args.beta))
        written = make_run_plots(args.run_dir, exact)
        print(f"wrote {len(written)} plots under {Path(args.run_dir) / 'plots'}")
    return 0


if __name__ == "__main__":
    from l2hmc.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
