from repro_torch.optim.optimizers import AdamState, Optimizer, adamw, cosine_schedule, sgd
