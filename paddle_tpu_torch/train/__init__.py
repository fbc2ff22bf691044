from paddle_tpu_torch.train.step import (  # noqa: F401
    TrainState, init_state, make_train_step)
from paddle_tpu_torch.train.elastic import (  # noqa: F401
    ElasticRunner, run_elastic)
from paddle_tpu_torch.train.trainer import Trainer, TrainerArgs  # noqa: F401
from paddle_tpu_torch.train.checkpoint import CheckpointManager  # noqa: F401
