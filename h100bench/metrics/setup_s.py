"""Set-up: process start to the window's start (interpreter, imports, the
kernels from the checkout's build cache, weights from the seed, graph
captures, warm-up)."""
from h100bench.lib.readers import setup_s as read  # noqa: F401
