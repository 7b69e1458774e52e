"""(6 N T + attention) a step, times the steps of the window, over the window
times the f32 peak, in %."""
from h100bench.lib.readers import train_mfu as read  # noqa: F401
