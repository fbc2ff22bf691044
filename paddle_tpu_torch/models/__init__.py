from paddle_tpu_torch.models.albert import (AlbertConfig,  # noqa: F401
                                            AlbertForMaskedLM, AlbertModel)
from paddle_tpu_torch.models.auto import (AUTO_REGISTRY,  # noqa: F401
                                          auto_config, auto_from_config,
                                          auto_from_pretrained)
from paddle_tpu_torch.models.bert import (  # noqa: F401
    BertConfig, BertForPretraining, BertForSequenceClassification, BertModel)
from paddle_tpu_torch.models.bloom import (BloomConfig,  # noqa: F401
                                           BloomForCausalLM)
from paddle_tpu_torch.models.decoding import generic_generate  # noqa: F401
from paddle_tpu_torch.models.distilbert import (  # noqa: F401
    DistilBertConfig, DistilBertForMaskedLM, DistilBertModel)
from paddle_tpu_torch.models.electra import (  # noqa: F401
    ElectraConfig, ElectraForPreTraining, ElectraModel)
from paddle_tpu_torch.models.ernie import (  # noqa: F401
    ErnieConfig, ErnieForMaskedLM, ErnieForSequenceClassification,
    ErnieModel)
from paddle_tpu_torch.models.ernie_m import (  # noqa: F401
    ErnieMConfig, ErnieMForSequenceClassification, ErnieMModel)
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
from paddle_tpu_torch.models.layoutlm import (  # noqa: F401
    LayoutLMConfig, LayoutLMForMaskedLM, LayoutLMModel)
from paddle_tpu_torch.models.llama import (LlamaConfig,  # noqa: F401
                                           LlamaForCausalLM, LlamaModel)
from paddle_tpu_torch.models.mistral import (MistralConfig,  # noqa: F401
                                             MistralForCausalLM, MistralModel)
from paddle_tpu_torch.models.mixtral import (MixtralConfig,  # noqa: F401
                                             MixtralForCausalLM)
from paddle_tpu_torch.models.moe_llm import MoEConfig, MoEForCausalLM  # noqa: F401
from paddle_tpu_torch.models.opt import OPTConfig, OPTForCausalLM  # noqa: F401
from paddle_tpu_torch.models.phi import PhiConfig, PhiForCausalLM  # noqa: F401
from paddle_tpu_torch.models.qwen import (Qwen2Config,  # noqa: F401
                                          Qwen2ForCausalLM, Qwen2Model)
from paddle_tpu_torch.models.qwen2_moe import (  # noqa: F401
    Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.models.roberta import (  # noqa: F401
    RobertaConfig, RobertaForMaskedLM, RobertaForSequenceClassification,
    RobertaModel)
from paddle_tpu_torch.models import convert  # noqa: F401
