"""Models of the port."""
from .gpt import (GPT, GPT_CONFIGS, GPTConfig, build_gpt, gpt_config,
                  gpt_loss_fn)

__all__ = ["GPT", "GPT_CONFIGS", "GPTConfig", "build_gpt", "gpt_config",
           "gpt_loss_fn"]
