"""The readings the limits of ``correct`` are set from, on the card at each
cell's own size.

    python3 portbench/calibrate.py --workloads gcn-reddit.train,... --seed <n> \
        --program 12 --control 3 [--out FILE]

For each cell, in one process: the set-up of a run, then whole training runs
of the program from ``--program`` lane seeds (the window's entry, its shapes
and its sizes), each compared with the plain reference; then the control, the
reference in float8 (e4m3, a scale a tensor) put in the program's place, and
the faults a training cell can have, put in the program's place in the
reference: ``half`` (half of the batch in the loss, the mean over the rest)
and ``frozen`` (the update left out: the state returned unchanged). Prints
each compared number's largest program reading (the lower reading) and
smallest control and fault readings, and writes every reading as JSON.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name: str, seed: int, n_program: int, n_control: int, log) -> dict:
    from portbench import data as bench_data
    from portbench import harness
    from portbench.reference.common import RefData

    cell = harness.Cell.load(name)
    t0 = time.perf_counter()
    su = harness.set_up(cell, seed, log)
    lanes, runs = [], []
    while len(lanes) < n_program:
        r = su.entry.run(harness.run_seeds(seed, len(runs), cell.lanes))
        runs.append({"seconds": r.seconds, "replays": r.replays, "epoch_s": r.epoch_s})
        lanes += list(zip(r.seeds, r.histories))
    log(f"{name}: set-up and {len(runs)} program runs in {time.perf_counter() - t0:.1f} s")
    data_dir, devices = su.data_dir, su.devices
    del su
    harness.release(devices)
    ref = RefData(bench_data.load_reference_arrays(data_dir), devices[0])
    out = {"program": harness.compare(cell, lanes, ref), "runs": runs}
    control = [(s, None) for s, _ in lanes[:n_control]]
    out["control"] = harness.compare(cell, control, ref, precision="fp8")
    for fault in ("half", "frozen"):
        out[fault] = harness.compare(cell, control, ref, fault=fault)
    return out


def summary(name: str, r: dict) -> list[str]:
    lines = []
    for k in (k for k in r["program"][0] if not k.startswith("_")):
        lo = max(x[k] for x in r["program"])
        ups = {src: min(x[k] for x in r[src]) for src in ("control", "half", "frozen")}
        lines.append(f"{name} {k}: program max {lo:.6g} | "
                     + " ".join(f"{src} min {v:.6g} ({v / lo if lo else float('inf'):.1f}x)"
                                for src, v in ups.items()))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--program", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from portbench import harness

    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    all_out = {}
    for name in args.workloads.split(","):
        all_out[name] = readings(name, args.seed, args.program, args.control, log)
        for line in summary(name, all_out[name]):
            print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(all_out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
