"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and behind a wrapper (``ops.py``) that launches the
kernel on CUDA tensors and runs the plain version on CPU tensors."""
