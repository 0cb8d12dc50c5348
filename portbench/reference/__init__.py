"""The plain reference: float32 PyTorch with TF32 off, no kernel of the
program, no cache, no batching. It imports neither JAX nor any package of
the program; what it needs of the program's set-up (the node order, each
epoch's dropout seeds, the dropout mask) it works out again from frozen
copies kept here and in ``portbench/data.py``."""
