"""``python -m repro_torch.experiments [--full] [--only NAME] [--device cpu]``:
the paper's experiments through ``repro_torch.experiments.run``."""
from repro_torch.experiments.run import main

main()
