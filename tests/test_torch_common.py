"""Shared helpers of the ``test_torch_*`` parity tests (no tests here).

Both packages get the same inputs, made with numpy from a seed, and the
same weights: the JAX model's ``state_dict()`` loaded into the port with
``models.convert.load_jax_state_dict``. JAX runs on the CPU, the port
with ``device="cpu"``, so every kernel wrapper runs its plain version.
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models import mixtral as jmix
from paddle_tpu.models import moe_llm as jmoe_llm
from paddle_tpu.models import qwen2_moe as jqwen
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models import mixtral as tmix
from paddle_tpu_torch.models import moe_llm as tmoe_llm
from paddle_tpu_torch.models import qwen2_moe as tqwen
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

# fp32 on the CPU, same algorithm on both sides: only the summation order
# of XLA's and ATen's matmuls/softmax differs, a few ulp per op through a
# 2-layer model
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_pair(seed=0, **kw):
    """(JAX model, port model) of ``LlamaConfig.tiny(**kw)`` with the same
    weights (fp32)."""
    pt.seed(seed)
    jm = JLlama(JLlamaConfig.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


# family -> (JAX model, JAX tiny config, port model, port tiny config, vocab)
MOE_FAMILIES = {
    "mixtral": (jmix.MixtralForCausalLM, jmix.MixtralConfig.tiny,
                tmix.MixtralForCausalLM, tmix.MixtralConfig.tiny, 128),
    "qwen2_moe": (jqwen.Qwen2MoeForCausalLM, jqwen.Qwen2MoeConfig.tiny,
                  tqwen.Qwen2MoeForCausalLM, tqwen.Qwen2MoeConfig.tiny, 128),
    # one dense layer, one MoE layer with capacity factor 1.25 (drops)
    "moe_llm": (jmoe_llm.MoEForCausalLM, jmoe_llm.MoEConfig.tiny,
                tmoe_llm.MoEForCausalLM, tmoe_llm.MoEConfig.tiny, 256),
}


def moe_pair(family, seed=0, **kw):
    """(JAX model, port model, vocab) of an MoE family's ``tiny``
    configuration with the same weights (fp32)."""
    jcls, jcfg, tcls, tcfg, vocab = MOE_FAMILIES[family]
    pt.seed(seed)
    jm = jcls(jcfg(**kw))
    tm = tcls(tcfg(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm, vocab


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))
