"""Evidence check — the JAX package's ``harness/evidence_check.py`` for the
port's records: fail when a cited result file is missing or a card result
carries no card.

  1. every ``output/...`` path cited in ``PERF.md`` and in the README's port
     section (from its ``## PyTorch + CUDA port`` heading to the next ``## ``
     heading) exists (a path with ``*`` must match at least one file);
  2. every row of every ``output/*_h100.txt`` carries the card's stamp (its
     name and power limit, as ``nvidia-smi --query-gpu=name,power.limit``
     prints them, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), on the row or
     on a ``#`` header line above it that covers the rows after it.

Exit 0 when both hold; otherwise 1, with one line for each problem.

Usage:
    python -m parallel_gcn_tpu_torch.harness.evidence_check [--root DIR]
"""

from __future__ import annotations

import argparse
import glob
import os
import re

CITED = re.compile(r"output/[\w.\-/*]+\.(?:txt|svg|json)")
STAMP = re.compile(r"H100[^\n\]]*?, \d+(?:\.\d+)? W")
PORT_SECTION = "## PyTorch + CUDA port"


def cited_paths(root: str) -> set[str]:
    """The ``output/`` paths that PERF.md and the README's port section cite."""
    texts = []
    perf = os.path.join(root, "PERF.md")
    if os.path.exists(perf):
        texts.append(open(perf).read())
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        text = open(readme).read()
        start = text.find(PORT_SECTION)
        if start >= 0:
            end = text.find("\n## ", start + len(PORT_SECTION))
            texts.append(text[start:end if end >= 0 else len(text)])
    return {m.group(0).rstrip(".") for t in texts for m in CITED.finditer(t)}


def missing_paths(root: str) -> list[str]:
    return [f"{rel} is cited but not present" for rel in sorted(cited_paths(root))
            if not glob.glob(os.path.join(root, rel))]


def unstamped_rows(root: str) -> list[str]:
    problems = []
    for path in sorted(glob.glob(os.path.join(root, "output", "*_h100.txt"))):
        header = False
        for i, line in enumerate(open(path), 1):
            if not line.strip():
                continue
            if line.startswith("#"):
                header = header or bool(STAMP.search(line))
                continue
            if not (header or STAMP.search(line)):
                problems.append(f"{os.path.relpath(path, root)}:{i} carries no card stamp")
    return problems


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the repository's root")
    args = ap.parse_args(argv)
    problems = missing_paths(args.root) + unstamped_rows(args.root)
    for p in problems:
        print(f"MISSING: {p}")
    if problems:
        print(f"\n{len(problems)} evidence problem(s)")
        return 1
    print(f"evidence check: {len(cited_paths(args.root))} cited paths present, every "
          f"*_h100.txt row stamped with its card")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
