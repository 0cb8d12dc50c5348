"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s`` from this process's start): imports, CUDA,
the data made or read, the program's data path, one short warm-up run of
the cell's shapes. Then the window: whole training runs back to back, each
from fresh weights and its own seed, the next started only while it is
expected to end within ``--seconds``. Then the comparison with the plain
reference, and one JSON line on standard output (the last): ``correct``,
``attempted``, ``failed``, ``metrics`` (end-to-end ones with ``--trace 0``,
per-layer ones with ``--trace 1``), ``device``, ``breakdown`` (traced) and
``checks``, each compared number beside its limit, which also close
standard error. Exits 1 without the CUDA devices the cell asks for, or if
the process holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# run from the checkout's root: the benchmark and the program import from
# there, and this file's own directory must not shadow the standard library
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    held = harness.forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} after the window", file=sys.stderr)
        return 1
    for name, c in out.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(out.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
