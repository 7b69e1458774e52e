from repro_torch.configs.base import ArchConfig, canonical, get, list_archs
