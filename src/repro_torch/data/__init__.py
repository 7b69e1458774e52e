"""Data of the paper's workload. Counterpart of ``repro.data`` (the token
pipeline waits for the training slice)."""
from repro_torch.data.synthetic import ClusteredTasks, generate_clustered_tasks
