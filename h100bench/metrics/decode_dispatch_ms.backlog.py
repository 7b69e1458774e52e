"""Host ms a decode dispatch takes in the batcher (its ``decode_s`` over its
``decode_dispatches``, from packing the inputs to the read-back that waits
for the device), over the window."""
from h100bench.lib.readers import decode_dispatch_ms as read  # noqa: F401
