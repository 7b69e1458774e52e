"""The paper's core objects that serving needs: the task-relatedness graph
and its mixing matrices (``graph``), and the delayed-iterate helpers of
Appendix G (``delayed``). Counterpart of ``repro.core``."""
from repro_torch.core.delayed import per_source_stale, theorem7_rate
from repro_torch.core.graph import (
    TaskGraph,
    band_graph,
    cluster_graph,
    complete_graph,
    disconnected_graph,
    knn_graph,
    ring_graph,
)
