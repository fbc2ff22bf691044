from paddle_tpu_torch.train.step import (  # noqa: F401
    TrainState, init_state, make_train_step)
