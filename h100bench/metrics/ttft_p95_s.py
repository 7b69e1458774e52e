"""95th percentile, over every request due in the window, of first-token time
minus due time; a request still without a token when the window closes
counts with the wait it has had."""
from h100bench.lib.readers import ttft_p95_s as read  # noqa: F401
