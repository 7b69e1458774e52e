"""Data of the paper's workload (``synthetic``) and the token pipeline of
the LM trainer (``tokens``). Counterpart of ``repro.data``."""
from repro_torch.data.synthetic import ClusteredTasks, generate_clustered_tasks
from repro_torch.data.tokens import TokenPipeline, synthetic_lm_batch
