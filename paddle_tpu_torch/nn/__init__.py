from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.layers import (LayerNorm, Linear,  # noqa: F401
                                        ReLU, Sequential)
