"""PyTorch/CUDA port of the repro package: serving and training of dense
GQA decoders with the paper's graph-multi-task update, and the paper's
solvers.

Counterpart of the JAX package ``repro``; imports ``torch`` and numpy only.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
