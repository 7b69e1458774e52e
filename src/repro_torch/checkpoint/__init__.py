from repro_torch.checkpoint.npz import load_pytree, save_pytree
