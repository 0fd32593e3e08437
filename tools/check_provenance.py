#!/usr/bin/env python
"""Cross-check every runs/ artifact cited in the docs against the tree.

The working tree is ephemeral: an artifact a doc cites must live in git,
or the citation dangles.  This checker makes the contract auditable:

  python tools/check_provenance.py          # report
  python tools/check_provenance.py --strict # exit 1 on missing citations

Glob citations (``runs/freeze_{8,16,32}_*.json``, ``runs/b5r_s*.json``)
are satisfied when at least one file matches.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import sys
from pathlib import Path

DOCS = ["README.md", "BASELINE.md", "MIGRATION.md", "PARITY.md",
        "docs/DESIGN.md", "PERF.md"]

CITE_RE = re.compile(r"runs/[A-Za-z0-9_.*{},/]+")


def normalize_citation(raw: str) -> str:
    """Strip sentence punctuation the citation regex may have swallowed."""
    return raw.rstrip(".,") if raw.endswith((".", ",")) else raw


def expand_braces(pat: str):
    """runs/freeze_{8,16}_*.json -> [runs/freeze_8_*.json, ...]."""
    m = re.search(r"\{([^{}]*)\}", pat)
    if not m:
        return [pat]
    head, tail = pat[: m.start()], pat[m.end():]
    return list(itertools.chain.from_iterable(
        expand_braces(head + opt + tail) for opt in m.group(1).split(",")))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero when a cited artifact is missing")
    args = p.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    cited: dict[str, set[str]] = {}
    for doc in DOCS:
        path = root / doc
        if not path.exists():
            continue
        for raw in CITE_RE.findall(path.read_text()):
            pat = normalize_citation(raw)
            # run DIRECTORIES (runs/gauge, runs/quickstart_b5) are cited
            # for their checkpoints/params; JSON artifacts for content
            cited.setdefault(pat, set()).add(doc)

    missing, present = [], []
    for pat in sorted(cited):
        hit = None
        for concrete in expand_braces(pat):
            matches = sorted(root.glob(concrete))
            if not matches and not concrete.endswith("*"):
                matches = sorted(root.glob(concrete + "*"))
            if matches:
                hit = matches
                break
        if hit:
            present.append((pat, len(hit)))
            for m in hit:
                if m.suffix == ".json" and m.is_file():
                    try:
                        json.loads(m.read_text())
                    except Exception as e:  # noqa: BLE001
                        print(f"UNPARSEABLE {m}: {e}")
                        missing.append((pat, cited[pat]))
        else:
            missing.append((pat, cited[pat]))

    print(f"cited artifact patterns: {len(cited)}  "
          f"present: {len(present)}  missing: {len(missing)}")
    for pat, docs in missing:
        print(f"  MISSING {pat}  (cited in {', '.join(sorted(docs))})")
    return 1 if (args.strict and missing) else 0


if __name__ == "__main__":
    raise SystemExit(main())
