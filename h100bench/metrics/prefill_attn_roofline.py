"""Prefill attention's share of its roofline in the traced window: the least
time of the valid rows of every traced prefill dispatch (each admitted
prompt's chunks from its cached prefix on; the dispatch j of a round holds
chunk j of each prompt) over the device time of the kernels named in
``kernels/prefill_attn/``, in %."""
from h100bench.lib.readers import prefill_attn_roofline as read  # noqa: F401
