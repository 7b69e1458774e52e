"""95th percentile of the time from a request's due time to the start of the
scheduling round that took it out of the batcher's queue, over the requests
due in the window (one still queued at the close counts with its wait)."""
from h100bench.lib.readers import queue_wait_p95_s as read  # noqa: F401
