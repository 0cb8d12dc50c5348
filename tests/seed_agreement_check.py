"""By-hand check, not a tier-1 test (pytest does not collect this file): do
synth-reddit's seeds agree to the node after 200 epochs in the JAX package
too, as the port's lanes do on the card (output/accuracy_h100_synth-reddit.txt:
val 56.27 ± 0.000 over 4 seeds)?

Both packages train 4 seeds of a downsized synth-reddit spec (10,000 nodes,
500,000 edges, the spec's widths, noise and split shares) for 200 epochs on
the CPU with ``parameters_synth-reddit.txt`` (``backend=segment``: the same
operator as the hybrid tiles without JAX's interpret-mode Pallas): the
JAX package through ``harness/accuracy.py``'s vmapped run, the port through
``seeds.fit_seeds``. Prints each package's val and test accuracy over the
seeds; the seeds agree where the spread is 0.

    python tests/seed_agreement_check.py
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("PGCN_CACHE_DIR", tempfile.mkdtemp(prefix="pgcn_seeds_"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import parallel_gcn_tpu.data.synthetic as jsynth  # noqa: E402
import parallel_gcn_tpu_torch.data.synthetic as tsynth  # noqa: E402
from harness import accuracy as jax_accuracy  # noqa: E402
from parallel_gcn_tpu_torch.config import default_params_path, load_config  # noqa: E402
from parallel_gcn_tpu_torch.data.parser import prepare_device_dataset  # noqa: E402
from parallel_gcn_tpu_torch.seeds import fit_seeds  # noqa: E402

SPEC = dict(n_nodes=10_000, n_edges=500_000, n_train=6_586, n_val=1_023)
SEEDS, EPOCHS = 4, 200
OVER = {"backend": "segment"}


def main() -> int:
    torch.set_num_threads(4)
    for mod in (jsynth, tsynth):
        mod.SYNTHETIC_SPECS["synth-reddit"] = {**mod.SYNTHETIC_SPECS["synth-reddit"], **SPEC}
    j = jax_accuracy.run_seeds("synth-reddit", SEEDS, EPOCHS, overrides=dict(OVER))
    print(f"JAX  val {j['val_mean']:.2f} ± {j['val_sd']:.3f} (max {j['val_max']:.2f}), test "
          f"{j['test_mean']:.2f} (max {j['test_max']:.2f}), epochs {j['epochs_mean']:.0f}",
          flush=True)
    cfg = load_config(default_params_path("synth-reddit"),
                      dict(OVER, epochs=EPOCHS, verbose=False, matmul_precision="default"))
    _, dds = prepare_device_dataset(cfg, "synth-reddit", torch.device("cpu"))
    r = fit_seeds(cfg, dds, list(range(SEEDS)))
    val, test = np.asarray(r.val_acc) * 100, np.asarray(r.test_acc) * 100
    print(f"port val {val.mean():.2f} ± {val.std(ddof=1):.3f} (lanes {np.round(val, 3)}), test "
          f"{test.mean():.2f} (lanes {np.round(test, 3)}), epochs {np.mean(r.epochs_run):.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
