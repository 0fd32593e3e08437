"""Post-trace op-level profile digest.

The reference dumps an op-view / scope-view auto-profiling report right
after its traced training window (``/root/reference/l2hmc/gauge_model.py:
1048-1071``: ``tf.contrib.tfprof.ProfileContext`` with
``add_auto_profiling('op', ...)`` and ``('scope', ...)``).  This build
captures the same window with ``jax.profiler.trace`` (``cli/train_gauge.py
--profile``), which writes an ``.xplane.pb`` plus a chrome-trace
``*.trace.json.gz``; this module digests the chrome trace into the
reference's UX — a top-k table of ops by total device time — written to
``<run_dir>/profile_top_ops.txt`` so a user never needs TensorBoard to see
where the step time went.
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def _find_trace_file(profile_dir: str | Path) -> Optional[Path]:
    """Latest ``*.trace.json.gz`` under ``profile_dir`` (jax.profiler lays
    out ``plugins/profile/<timestamp>/<host>.trace.json.gz``)."""
    root = Path(profile_dir)
    if not root.exists():
        return None
    cands = sorted(root.rglob("*.trace.json.gz"))
    return cands[-1] if cands else None


def _is_device_process(name: str) -> bool:
    n = name.lower()
    return "device" in n or "gpu" in n


def digest_trace(
    profile_dir: str | Path, top_k: int = 25
) -> List[Tuple[str, float, int, float]]:
    """Aggregate the chrome trace into ``(op_name, total_ms, count, pct)``
    rows, sorted by total duration, truncated to ``top_k``.

    Device-lane events are preferred (the xplane conversion emits
    per-device processes); if none exist (CPU traces) the XLA runtime
    threads are used instead, with pure python-frame events dropped.
    """
    tf = _find_trace_file(profile_dir)
    if tf is None:
        return []
    with gzip.open(tf, "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])

    proc_names: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e.get("pid")] = e.get("args", {}).get("name", "")

    device_pids = {p for p, n in proc_names.items() if _is_device_process(n)}

    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        if device_pids:
            if e.get("pid") not in device_pids:
                continue
            # drop whole-program/module spans (the 'jit_<fn>' module lane
            # and the bare step-number lane) so the table shows op-level
            # entries, like the reference's op view
            if name.startswith("jit_") or name.isdigit():
                continue
        elif name.startswith("$"):   # python frame events in CPU traces
            continue
        dur_us = float(e.get("dur", 0.0))
        totals[name] += dur_us
        counts[name] += 1

    grand = sum(totals.values()) or 1.0
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top_k]
    return [
        (name, t / 1e3, counts[name], 100.0 * t / grand) for name, t in rows
    ]


def format_table(rows: List[Tuple[str, float, int, float]]) -> str:
    """Reference-style op-view table (total-ms ordered)."""
    if not rows:
        return "no trace events found\n"
    width = max(len(r[0]) for r in rows)
    width = min(max(width, 8), 80)
    lines = [
        f"{'op':<{width}}  {'total_ms':>10}  {'count':>7}  {'pct':>6}",
        "-" * (width + 30),
    ]
    for name, ms, n, pct in rows:
        lines.append(f"{name[:width]:<{width}}  {ms:>10.3f}  {n:>7d}  "
                     f"{pct:>5.1f}%")
    return "\n".join(lines) + "\n"


def write_digest(profile_dir: str | Path, run_dir: str | Path,
                 top_k: int = 25) -> Optional[Path]:
    """Digest the trace and write ``<run_dir>/profile_top_ops.txt``.

    Returns the written path, or None if no trace was found.  Mirrors the
    reference's dump-once-after-the-window behavior
    (``gauge_model.py:1066-1071``).
    """
    rows = digest_trace(profile_dir, top_k)
    if not rows:
        return None
    out = Path(run_dir) / "profile_top_ops.txt"
    out.write_text(format_table(rows))
    return out
