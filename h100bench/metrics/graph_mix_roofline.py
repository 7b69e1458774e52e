"""The graph mix's share of its roofline in the traced window: 2 m^2 d
operations and mu, theta and the output once per launch of a kernel named
in ``kernels/graph_mix/`` (one launch mixes the store's whole (m, d)
tree), over those launches' device time, in %."""
from h100bench.lib.readers import graph_mix_roofline as read  # noqa: F401
