"""Tokens of the training steps that completed in the window (synchronized at
its end), over the window."""
from h100bench.lib.readers import train_tok_s as read  # noqa: F401
