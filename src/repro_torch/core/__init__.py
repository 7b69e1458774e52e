"""The paper's core, counterpart of ``repro.core``: the task-relatedness
graph and its mixing matrices (``graph``), the objective and losses
(``objective``), the batch solvers of Section 3 (``algorithms``), the
stochastic solvers of Section 4 (``stochastic``), the baselines of Section 6
(``baselines``), the consensus limit of Section 5 (``consensus``),
delay-tolerant BOL of Appendix G (``delayed``), alternating graph learning
(``graph_learning``), the statistical theory (``theory``), the mixed
update of the LM trainer (``distributed.GraphMultiTask``), and the
distributed programs over ``torch.distributed``, one task per rank: the
collectives ``mix_all_gather`` / ``mix_ring`` (``distributed``) and the
sharded solvers ``bol_sharded`` / ``bsr_sharded`` (``runners``). They run
in plain torch where the reference runs plain ``jnp``, on the inputs'
device; the collectives on NCCL for CUDA tensors and gloo for CPU ones."""
from repro_torch.core.graph import (
    TaskGraph,
    band_graph,
    cluster_graph,
    complete_graph,
    disconnected_graph,
    knn_graph,
    ring_graph,
)
from repro_torch.core.objective import (
    LOGISTIC,
    SQUARED,
    Loss,
    MultiTaskProblem,
    local_ridge_solution,
)
from repro_torch.core.algorithms import RunResult, bol, bsr, gd
from repro_torch.core.stochastic import minibatch_prox, minibatch_sampler, sol, ssr
from repro_torch.core.baselines import admm, centralized_solution, local_solution, sdca
from repro_torch.core.delayed import bol_delayed, per_source_stale, theorem7_rate
from repro_torch.core.consensus import consensus_distance, consensus_sgd
from repro_torch.core.graph_learning import (
    alternating_graph_learning,
    laplacian_from_relationship,
    mtrl_relationship,
)
from repro_torch.core.distributed import (
    GraphMultiTask,
    mix_all_gather,
    mix_ring,
    mixing_spec_for_band_graph,
)
from repro_torch.core.runners import bol_sharded, bsr_sharded
from repro_torch.core import theory
