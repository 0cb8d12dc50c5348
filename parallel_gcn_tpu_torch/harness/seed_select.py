"""Per-dataset seed selection — the JAX package's ``harness/seed_select.py``
over the port (the analog of the reference's shipped tuned seeds,
parameters/parameters_cora.txt seed=1382895624, report p.14).

Seeds train in batches of lanes (``seeds.fit_seeds``), lane s being
``fit`` with ``seed=s``, so a seed chosen here reproduces through
``python -m parallel_gcn_tpu_torch <ds> seed=<s>``. The JAX harness re-scores
the head of its ranking solo because its batched bf16 matmuls drift from a
solo run's. Here a lane is its solo run, so the re-scoring is a check: every
solo score must equal its lane's, and the output says whether it did. The
parameter files are not edited: their seeds are the JAX package's threefry
seeds.

Usage:
    python -m parallel_gcn_tpu_torch.harness.seed_select [dataset ...] [--seeds N]
        [--batch B] [--base N] [--verify N] [--device cuda|cpu] [--out-dir D]

Prints the top 10 seeds by (test_acc, val_acc) and writes
``<out-dir>/seed_select_<ds>_h100.txt``.
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np

from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset
from parallel_gcn_tpu_torch.device import resolve_device
from parallel_gcn_tpu_torch.harness import common
from parallel_gcn_tpu_torch.seeds import fit_seeds
from parallel_gcn_tpu_torch.train import fit

PUBLISHED_TEST = {"citeseer": 80.0, "cora": 87.9, "pubmed": 89.6}
RE_VERIFY_TOP = 20


def sweep_seeds(dataset: str, n_seeds: int, batch: int, base: int, verify: int = RE_VERIFY_TOP,
                device: str = "cuda"):
    """(the head re-run solo: [(seed, test, val, epochs, solo == lane)], the
    batch ranking [(seed, test, val, epochs)], the card)."""
    dev = resolve_device(device)
    # the parameter file's own precision, so that a choice transfers to the CLI
    cfg = common.config(dataset, dict(verbose=False))
    _, dds = prepare_device_dataset(cfg, dataset, dev)
    rows = []
    t0 = time.time()
    for start in range(0, n_seeds, batch):
        seeds = list(range(base + start, base + min(start + batch, n_seeds)))
        r = fit_seeds(cfg, dds, seeds)
        rows += [(s, float(t), float(v), int(e), h)
                 for s, t, v, e, h in zip(seeds, r.test_acc, r.val_acc, r.epochs_run, r.history)]
        best = max(rows, key=lambda row: (row[1], row[2]))
        print(f"[{dataset}] {len(rows)}/{n_seeds} seeds, best so far: seed={best[0]} "
              f"test={best[1] * 100:.2f} val={best[2] * 100:.2f} ({time.time() - t0:.0f}s)",
              flush=True)
    rows.sort(key=lambda row: (row[1], row[2]), reverse=True)
    verified = []
    for s, t, v, e, hist in rows[:verify]:
        solo_cfg = copy.deepcopy(cfg)
        solo_cfg.tpu.seed = s
        solo = fit(solo_cfg, dds)
        sv = float(solo.history[max(solo.epochs_run - 1, 0), 3])
        same = (solo.epochs_run == e and np.array_equal(solo.history, hist)
                and float(solo.test_acc) == t)
        verified.append((s, float(solo.test_acc), sv, solo.epochs_run, same))
    verified.sort(key=lambda row: (row[1], row[2]), reverse=True)
    return verified, [row[:4] for row in rows], common.card(dev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="*", default=None)
    ap.add_argument("--seeds", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--base", type=int, default=0)
    ap.add_argument("--verify", type=int, default=RE_VERIFY_TOP,
                    help="the head of the ranking re-run solo")
    common.add_common(ap)
    args = ap.parse_args(argv)
    for name in args.datasets or ["cora", "citeseer"]:
        try:
            verified, rows, card = sweep_seeds(name, args.seeds, args.batch, args.base,
                                               args.verify, args.device)
        except FileNotFoundError:
            common.unavailable(name)
            continue
        pub = PUBLISHED_TEST.get(name)
        equal = all(row[4] for row in verified)
        lines = [f"# {name}: {args.seeds} seeds from base {args.base} in lanes of {args.batch} "
                 f"on {card}; published test = {pub}",
                 f"# top {len(verified)} re-run solo: every solo run equals its lane: {equal}",
                 "# seed test_acc val_acc epochs_run solo_equals_lane"]
        lines += [f"{s} {t * 100:.2f} {v * 100:.2f} {e} {same}" for s, t, v, e, same in verified]
        lines.append("# the lanes' ranking")
        lines += [f"{s} {t * 100:.2f} {v * 100:.2f} {e}" for s, t, v, e in rows]
        common.write(args.out_dir, f"seed_select_{name}_h100.txt", lines)
        print(f"\n== {name} top-10 (published test {pub}); solo equals lane for all "
              f"{len(verified)} re-run: {equal} ==")
        for s, t, v, e, _ in verified[:10]:
            mark = " <-- beats published" if pub and t * 100 >= pub else ""
            print(f"  seed={s:6d} test={t * 100:.2f} val={v * 100:.2f} epochs={e}{mark}")
        if verified:
            print(f"  suggested: seed={verified[0][0]} (parameters/ files are not edited)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
