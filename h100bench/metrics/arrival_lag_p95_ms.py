"""How late the load generator submitted: 95th percentile of submit time
minus due time, in ms, over the requests due in the window (one never
submitted counts with the lag it had when the window closed)."""
from h100bench.lib.readers import arrival_lag_p95_ms as read  # noqa: F401
