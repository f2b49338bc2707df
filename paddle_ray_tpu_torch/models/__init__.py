"""Models of the port."""
from .generation import generate, quantize_for_decode
from .gpt import (GPT, GPT_CONFIGS, GPTConfig, build_gpt, gpt_config,
                  gpt_loss_fn)
from .unet import UNet, UNetConfig, build_unet, timestep_embedding, unet_loss_fn

__all__ = ["GPT", "GPT_CONFIGS", "GPTConfig", "UNet", "UNetConfig",
           "build_gpt", "build_unet", "generate", "gpt_config", "gpt_loss_fn",
           "quantize_for_decode", "timestep_embedding", "unet_loss_fn"]
