from repro_torch.train.trainer import (
    TrainState,
    batch_to_device,
    init_state,
    make_train_step,
    train_loop,
)
