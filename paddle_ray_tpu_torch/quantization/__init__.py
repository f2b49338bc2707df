"""Int8 quantization of the port: dynamic PTQ, QAT and weight-only int8."""
from .quant import (PTQ, QAT, BaseObserver, BaseQuanter, QATLinear,
                    QuantConfig, QuantizedLinear, WeightOnlyInt8Embedding,
                    WeightOnlyInt8Linear, dequantize, fake_quant, quanter,
                    quantize_model, quantize_per_channel,
                    quantize_per_tensor, replace_layers)

__all__ = ["QAT", "QATLinear", "QuantizedLinear", "dequantize", "fake_quant",
           "quantize_per_channel", "quantize_per_tensor", "quantize_model",
           "PTQ", "QuantConfig", "BaseObserver", "BaseQuanter", "quanter",
           "WeightOnlyInt8Embedding", "WeightOnlyInt8Linear",
           "replace_layers"]
