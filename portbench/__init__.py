"""The benchmark of parallel_gcn_tpu_torch (see README.md)."""
