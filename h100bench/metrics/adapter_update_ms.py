"""Device ms per adapter-store ``update()`` in the traced window: CUDA events
recorded on the stream before and after each call."""
from h100bench.lib.readers import adapter_update_ms as read  # noqa: F401
