"""Weight-only int8 quantization of the port."""
from .quant import (WeightOnlyInt8Embedding, WeightOnlyInt8Linear,
                    quantize_per_channel, replace_layers)

__all__ = ["WeightOnlyInt8Embedding", "WeightOnlyInt8Linear",
           "quantize_per_channel", "replace_layers"]
