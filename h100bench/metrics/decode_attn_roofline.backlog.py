"""Decode attention's share of its roofline in the traced window: the least
time of every traced decode dispatch's live rows (their visible K/V once,
from the harness's record of each row's context) over the device time of
the kernels named in ``kernels/decode_attn/``, in %."""
from h100bench.lib.readers import decode_attn_roofline as read  # noqa: F401
