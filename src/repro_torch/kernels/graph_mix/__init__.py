from repro_torch.kernels.graph_mix.ops import graph_mix, graph_mix_tree
from repro_torch.kernels.graph_mix.ref import graph_mix_reference, graph_mix_tree_reference
