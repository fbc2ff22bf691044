from paddle_tpu_torch.models.llama import (LlamaConfig,  # noqa: F401
                                           LlamaForCausalLM)
from paddle_tpu_torch.models.mistral import (MistralConfig,  # noqa: F401
                                             MistralForCausalLM, MistralModel)
from paddle_tpu_torch.models.qwen import (Qwen2Config,  # noqa: F401
                                          Qwen2ForCausalLM, Qwen2Model)
