"""Models of the port."""
from .generation import generate, quantize_for_decode
from .gpt import (GPT, GPT_CONFIGS, GPTConfig, build_gpt, gpt_config,
                  gpt_loss_fn)

__all__ = ["GPT", "GPT_CONFIGS", "GPTConfig", "build_gpt", "generate",
           "gpt_config", "gpt_loss_fn", "quantize_for_decode"]
