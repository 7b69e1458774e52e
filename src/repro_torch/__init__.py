"""PyTorch/CUDA port of the repro serving stack (dense GQA decoders).

Counterpart of the JAX package ``repro``; imports ``torch`` and numpy only.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
