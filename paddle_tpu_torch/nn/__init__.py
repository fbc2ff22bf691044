from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.layers import (Dropout, Embedding,  # noqa: F401
                                        LayerList, LayerNorm, Linear, ReLU,
                                        Sequential)
from paddle_tpu_torch.nn.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
