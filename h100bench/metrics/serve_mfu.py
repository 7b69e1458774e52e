"""Useful operations over the window (2 N a computed prompt or generated
token, its attention over its visible context, its adapter products; no
slab row without a token) over the window times the f32 peak, in %."""
from h100bench.lib.readers import serve_mfu as read  # noqa: F401
