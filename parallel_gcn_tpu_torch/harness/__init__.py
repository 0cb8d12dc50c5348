"""The port's harnesses: the JAX package's ``harness/`` over the port.

Each runs as ``python -m parallel_gcn_tpu_torch.harness.<name>`` on the card
(the default device) or with ``--device cpu``, and writes its results under
``--out-dir`` (default ``output/``) in files of its own (``*_h100.txt``),
each row stamped with the device it ran on.
"""
