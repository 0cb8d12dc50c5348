"""Plotting harness — the JAX package's ``harness/plots.py`` over the port's
result files: SVG figures (matplotlib) from ``output/*_h100.txt``.

  performance — scan ms/epoch a dataset against the reference's published
                T4 and CPU baselines (``performance_h100.txt``, which carries
                them a row)
  layout      — ms/epoch across each layout sweep (``tuning_layout_*_h100.txt``)
  accuracy    — val accuracy mean ± sd over seeds of the best configurations
                (``tuning_*_h100.txt``)
  scaling     — scaling efficiency over ranks by halo (``scaling_h100.txt``)

A figure whose input file is missing is skipped, as the JAX harness does.

Usage:
    python -m parallel_gcn_tpu_torch.harness.plots [performance|layout|accuracy|scaling|all]
        [--in-dir output] [--out-dir output/plots]
"""

from __future__ import annotations

import argparse
import json
import os
import re

# the JAX harness's palette: ours blue, reference GPU orange, reference CPU aqua
C_OURS = "#2a78d6"
C_GPU = "#eb6834"
C_CPU = "#1baf7a"
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"
GRID = "#e5e4e0"


def _style(ax, title: str) -> None:
    ax.set_facecolor(SURFACE)
    ax.set_title(title, color=INK, fontsize=11, loc="left", pad=10)
    ax.tick_params(colors=INK2, labelsize=8.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.set_axisbelow(True)


def _save(fig, out_dir: str, name: str) -> str:
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.patch.set_facecolor(SURFACE)
    fig.savefig(path, format="svg", bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")
    return path


def _card(text: str) -> str:
    m = re.search(r"\[([^\]]*H100[^\]]*)\]", text) or re.search(r"on (.*H100[^(;]*W)", text)
    return m.group(1).strip() if m else "H100"


def plot_performance(in_dir: str, out_dir: str) -> list[str]:
    import matplotlib.pyplot as plt
    import numpy as np

    src = os.path.join(in_dir, "performance_h100.txt")
    if not os.path.exists(src):
        print(f"skip performance: {src} missing")
        return []
    rows = [json.loads(ln) for ln in open(src) if ln.strip() and not ln.startswith("#")]
    rows = [r for r in rows if r.get("baseline_t4_ms")]
    if not rows:
        print("skip performance: no dataset with a published baseline")
        return []
    x = np.arange(len(rows))
    ours = [r["epoch_ms_median"] for r in rows]
    fig, ax = plt.subplots(figsize=(7, 4))
    w = 0.26
    ax.bar(x - w, ours, w * 0.92, color=C_OURS, label=rows[0].get("card", "H100"))
    ax.bar(x, [r["baseline_t4_ms"] for r in rows], w * 0.92, color=C_GPU,
           label="Tesla T4 (reference)")
    ax.bar(x + w, [r["baseline_cpu_ms"] for r in rows], w * 0.92, color=C_CPU,
           label="CPU (reference)")
    ax.set_yscale("log")
    ax.set_xticks(x, [r["dataset"] for r in rows])
    ax.set_ylabel("ms/epoch (log)", color=INK2, fontsize=9)
    for xi, r, o in zip(x, rows, ours):
        ax.annotate(f"{r['baseline_t4_ms'] / o:.1f}×", (xi - w, o), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8, color=INK)
    ax.legend(frameon=False, fontsize=8.5, labelcolor=INK)
    ax.yaxis.grid(True, color=GRID, linewidth=0.6)
    _style(ax, "Training epoch time — the port against the reference's baselines")
    return [_save(fig, out_dir, "performance_comparison_h100.svg")]


def plot_layout(in_dir: str, out_dir: str) -> list[str]:
    import matplotlib.pyplot as plt
    import numpy as np

    sources = sorted(f for f in os.listdir(in_dir)
                     if f.startswith("tuning_layout_") and f.endswith("_h100.txt"))
    if not sources:
        print("skip layout: no tuning_layout_*_h100.txt")
        return []
    paths = []
    for f in sources:
        text = open(os.path.join(in_dir, f)).read()
        rows = []
        for line in text.splitlines():
            parts = line.split()
            if len(parts) >= 3 and not line.startswith("#"):
                rows.append((float(parts[0]), parts[1], parts[2]))
        if not rows:
            continue
        dataset = rows[0][1]
        rows.sort(reverse=True)
        y = np.arange(len(rows))
        fig, ax = plt.subplots(figsize=(7, 0.42 * len(rows) + 1.2))
        best = min(r[0] for r in rows)
        ax.barh(y, [r[0] for r in rows], 0.62,
                color=[C_GPU if r[0] == best else C_OURS for r in rows])
        ax.set_yticks(y, [r[2] for r in rows], fontsize=8)
        ax.set_xlabel(f"ms/epoch on {_card(text)}", color=INK2, fontsize=9)
        for yi, r in zip(y, rows):
            ax.annotate(f"{r[0]:.2f}", (r[0], yi), textcoords="offset points",
                        xytext=(4, -3), fontsize=8, color=INK2)
        ax.xaxis.grid(True, color=GRID, linewidth=0.6)
        _style(ax, f"Layout sweep — {dataset} (best in orange)")
        paths.append(_save(fig, out_dir, f"tuning_layout_{dataset}_h100.svg"))
    return paths


def plot_accuracy(in_dir: str, out_dir: str) -> list[str]:
    import matplotlib.pyplot as plt
    import numpy as np

    sources = sorted(f for f in os.listdir(in_dir) if f.startswith("tuning_")
                     and f.endswith("_h100.txt") and not f.startswith("tuning_layout"))
    if not sources:
        print("skip accuracy: no tuning_<dataset>_h100.txt")
        return []
    paths = []
    for fname in sources:
        dataset = fname[len("tuning_"):-len("_h100.txt")]
        text = open(os.path.join(in_dir, fname)).read()
        rows = []
        for line in text.splitlines():
            label = line.split("[")[0].split()
            if len(label) >= 4 and not line.startswith("#"):
                rows.append((float(label[0]), float(label[1]), " ".join(label[3:])))
        if not rows:
            continue
        rows = sorted(rows, reverse=True)[:15][::-1]
        y = np.arange(len(rows))
        fig, ax = plt.subplots(figsize=(7, 0.42 * len(rows) + 1.2))
        ax.errorbar([r[0] for r in rows], y, xerr=[r[1] for r in rows], fmt="o", markersize=6,
                    color=C_OURS, ecolor=INK2, elinewidth=1.2, capsize=3)
        ax.set_yticks(y, [r[2] for r in rows], fontsize=8)
        ax.set_xlabel(f"val accuracy, mean ± sd over seeds (%), {_card(text)}", color=INK2,
                      fontsize=9)
        ax.xaxis.grid(True, color=GRID, linewidth=0.6)
        _style(ax, f"Hyperparameter sweep — {dataset}, top configurations")
        paths.append(_save(fig, out_dir, f"tuning_accuracy_{dataset}_h100.svg"))
    return paths


def plot_scaling(in_dir: str, out_dir: str) -> list[str]:
    import matplotlib.pyplot as plt

    src = os.path.join(in_dir, "scaling_h100.txt")
    if not os.path.exists(src):
        print(f"skip scaling: {src} missing")
        return []
    text = open(src).read()
    series: dict = {}
    for m in re.finditer(r"^(\S+) +n= *(\d+) .*efficiency +(\S+)%", text, re.M):
        series.setdefault(m.group(1), []).append((int(m.group(2)), float(m.group(3))))
    if not series:
        print("skip scaling: empty file")
        return []
    fig, ax = plt.subplots(figsize=(7, 4))
    for (name, pts), color in zip(sorted(series.items()), (C_OURS, C_GPU, C_CPU)):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", markersize=5,
                linewidth=2, color=color, label=name)
    ax.set_xscale("log", base=2)
    ax.set_xlabel(f"ranks (one {_card(text)} each)", color=INK2, fontsize=9)
    ax.set_ylabel("scaling efficiency (%)", color=INK2, fontsize=9)
    ax.legend(frameon=False, fontsize=8.5, labelcolor=INK)
    ax.yaxis.grid(True, color=GRID, linewidth=0.6)
    _style(ax, "Multi-card scaling efficiency by halo")
    return [_save(fig, out_dir, "scaling_h100.svg")]


ALL = {"performance": plot_performance, "layout": plot_layout, "accuracy": plot_accuracy,
       "scaling": plot_scaling}


def main(argv: list[str] | None = None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("figures", nargs="*", default=["all"])
    ap.add_argument("--in-dir", default="output")
    ap.add_argument("--out-dir", default=os.path.join("output", "plots"))
    args = ap.parse_args(argv)
    names = list(ALL) if args.figures == ["all"] else args.figures
    for name in names:
        if name not in ALL:
            print(f"unknown figure '{name}' (choose from {', '.join(ALL)} or all)")
            return 1
        ALL[name](args.in_dir, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
