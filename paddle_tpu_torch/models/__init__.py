"""Models of the port (mirrors ``paddle_tpu/models``)."""

from .convert import load_jax_state_dict
from .generation import init_kv_cache, sample_tokens
from .llama import (LlamaConfig, LlamaForCausalLM, config_from,
                    llama3_8b_config, tiny_llama_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "config_from",
           "init_kv_cache", "llama3_8b_config", "load_jax_state_dict",
           "sample_tokens", "tiny_llama_config"]
