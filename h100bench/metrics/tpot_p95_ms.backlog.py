"""95th percentile, over the requests that completed in the window, of
(last - first token time) / (tokens - 1), in ms."""
from h100bench.lib.readers import tpot_p95_ms as read  # noqa: F401
