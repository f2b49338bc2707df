"""Models of the port."""
from .bert import (BERT_CONFIGS, Bert, BertConfig, BertForPretraining,
                   bert_config, bert_pretrain_loss_fn)
from .generation import generate, quantize_for_decode
from .gpt import (GPT, GPT_CONFIGS, GPTConfig, build_gpt, gpt_config,
                  gpt_loss_fn)
from .unet import UNet, UNetConfig, build_unet, timestep_embedding, unet_loss_fn

__all__ = ["BERT_CONFIGS", "Bert", "BertConfig", "BertForPretraining",
           "bert_config", "bert_pretrain_loss_fn", "GPT", "GPT_CONFIGS",
           "GPTConfig", "UNet", "UNetConfig", "build_gpt", "build_unet", "generate", "gpt_config", "gpt_loss_fn",
           "quantize_for_decode", "timestep_embedding", "unet_loss_fn"]
