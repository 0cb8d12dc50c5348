"""parallel_gcn_tpu_torch — the GCN trainer of ``parallel_gcn_tpu`` in PyTorch.

A port of the JAX package to PyTorch and hand-written CUDA kernels for one
NVIDIA Hopper GPU (H100, ``sm_90a``). Module names mirror the JAX package's,
so each file's counterpart is easy to find:

- ``config``: the same parameter files and config dataclasses.
- ``data``: numpy host code (graph building, reordering, synthetic
  datasets, readers) and the torch ``Graph`` on a given device.
- ``ops``: aggregation (``graphsum``) over dense / COO / BCSR tile packs,
  dropout, the feature transform and the masked softmax-CE. The tile SpMM
  and the dropout are CUDA kernels (``csrc/``) with a plain PyTorch version
  beside each, used for CPU tensors.
- ``models.gcn``: the N-layer GCN; ``optim``: Adam; ``train``: ``fit``;
  ``utils.checkpoint``: checkpoints in the JAX package's format.

The package imports torch and numpy only: never jax, never
``parallel_gcn_tpu``.
"""

__version__ = "0.1.0"

from parallel_gcn_tpu_torch.config import Config, load_config
from parallel_gcn_tpu_torch.device import resolve_device

__all__ = ["Config", "load_config", "resolve_device", "__version__"]
