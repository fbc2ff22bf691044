from paddle_tpu_torch.models.auto import (AUTO_REGISTRY,  # noqa: F401
                                          auto_config, auto_from_config,
                                          auto_from_pretrained)
from paddle_tpu_torch.models.bloom import (BloomConfig,  # noqa: F401
                                           BloomForCausalLM)
from paddle_tpu_torch.models.decoding import generic_generate  # noqa: F401
from paddle_tpu_torch.models.falcon import (FalconConfig,  # noqa: F401
                                            FalconForCausalLM)
from paddle_tpu_torch.models.gemma import (GemmaConfig,  # noqa: F401
                                           GemmaForCausalLM)
from paddle_tpu_torch.models.glm import GlmConfig, GlmForCausalLM  # noqa: F401
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM  # noqa: F401
from paddle_tpu_torch.models.gpt_neox import (GPTNeoXConfig,  # noqa: F401
                                              GPTNeoXForCausalLM)
from paddle_tpu_torch.models.gptj import (CodeGenConfig,  # noqa: F401
                                          CodeGenForCausalLM, GPTJConfig,
                                          GPTJForCausalLM)
from paddle_tpu_torch.models.llama import (LlamaConfig,  # noqa: F401
                                           LlamaForCausalLM)
from paddle_tpu_torch.models.mistral import (MistralConfig,  # noqa: F401
                                             MistralForCausalLM, MistralModel)
from paddle_tpu_torch.models.opt import OPTConfig, OPTForCausalLM  # noqa: F401
from paddle_tpu_torch.models.phi import PhiConfig, PhiForCausalLM  # noqa: F401
from paddle_tpu_torch.models.qwen import (Qwen2Config,  # noqa: F401
                                          Qwen2ForCausalLM, Qwen2Model)
