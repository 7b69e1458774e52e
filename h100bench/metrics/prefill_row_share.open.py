"""The share of the prefill slab's rows that held a prompt token: the
batcher's prompt tokens computed over its prefill dispatches times slots
times the chunk, over the window, in %."""
from h100bench.lib.readers import prefill_row_share as read  # noqa: F401
