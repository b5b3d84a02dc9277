"""Models of the port (mirrors ``paddle_tpu/models``)."""

from .convert import (load_jax_optimizer_state, load_jax_quantized_state_dict,
                      load_jax_state_dict)
from .diffusion import (DDIMSampler, ddim_sample, ddim_timesteps,
                        diffusion_schedule)
from .dit import DiT, DiTConfig, dit_xl_2_config, tiny_dit_config
from .generation import accept_draft_tokens, init_kv_cache, sample_tokens
from .llama import (LlamaConfig, LlamaForCausalLM, causal_lm_loss,
                    config_from, draft_model_from, llama3_8b_config,
                    mask_boundary_labels, tiny_llama_config)
from .quantized import QuantizedForDecode, quantize_for_decode

__all__ = ["DDIMSampler", "DiT", "DiTConfig", "LlamaConfig", "LlamaForCausalLM", "QuantizedForDecode",
           "accept_draft_tokens", "causal_lm_loss", "config_from",
           "ddim_sample", "ddim_timesteps", "diffusion_schedule",
           "dit_xl_2_config", "draft_model_from", "init_kv_cache",
           "llama3_8b_config", "load_jax_optimizer_state",
           "load_jax_quantized_state_dict", "load_jax_state_dict",
           "mask_boundary_labels", "quantize_for_decode", "sample_tokens",
           "tiny_dit_config", "tiny_llama_config"]
