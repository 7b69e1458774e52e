"""Every token generated in the window, over the window."""
from h100bench.lib.readers import output_tok_s as read  # noqa: F401
