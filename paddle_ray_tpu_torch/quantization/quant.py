"""Int8 quantization (the port of ``paddle_ray_tpu/quantization/quant.py``).

Symmetric int8: ``scale = max(max|x|, 1e-8) / 127`` over the reduced axes
(all of them per tensor), ``q = clip(round(x / scale), -128, 127)`` (round
half to even, as ``jnp.round``), in the JAX package's types -- the same
bits.

- Dynamic PTQ: :class:`QuantizedLinear` holds an int8 ``[in, out]``
  weight with per-output-channel (or one) scale and quantizes its input per
  tensor at every call; its product runs the int8 tensor-core kernel of
  :func:`..ops.fused.int8_mm`.  :func:`quantize_model` and :class:`PTQ`
  replace every :class:`..nn.layers.Linear` with one (the tensor-parallel
  linears of :mod:`..parallel.tp` are no ``Linear`` subclasses and stay,
  as in JAX).
- QAT: :func:`fake_quant` (straight-through gradient), :class:`QATLinear`
  and :class:`QAT`, whose ``convert`` emits :class:`QuantizedLinear` layers.
- The reference configuration surface: :class:`QuantConfig`,
  :class:`BaseQuanter`, :class:`BaseObserver`, :func:`quanter`.
- Weight-only int8 for decode: :class:`WeightOnlyInt8Linear` keeps
  activations exact and scales each output channel;
  :class:`WeightOnlyInt8Embedding` scales each row and serves the tied LM
  head through a pre-transposed copy.

The int8 modules hold their tensors as buffers: they are inference-only.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..amp.auto_cast import cast_if_enabled
from ..nn.layers import Linear
from ..ops.decode_matmul import MAX_KERNEL_ROWS, int8_stream_matmul
from ..ops.fused import int8_mm

__all__ = ["quantize_per_tensor", "quantize_per_channel", "dequantize",
           "fake_quant", "QuantizedLinear", "quantize_model", "QAT",
           "QATLinear", "PTQ", "QuantConfig", "BaseObserver", "BaseQuanter",
           "quanter", "replace_layers", "WeightOnlyInt8Linear",
           "WeightOnlyInt8Embedding"]


def _scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``max(amax, 1e-8) / qmax`` by a true division on every device:
    PyTorch's CUDA divide by a Python number multiplies by its reciprocal,
    which can differ from JAX's quotient in the last bit; a divisor held
    in a tensor is divided by."""
    amax = torch.clamp(amax, min=1e-8)
    return amax / torch.full((), qmax, dtype=amax.dtype, device=amax.device)


def quantize_per_tensor(x: torch.Tensor, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization -> (int8 values, float32 scalar
    scale), computed in x's dtype as the JAX function does.  The scale
    stays on x's device: nothing is fetched to the host."""
    qmax = 2 ** (bits - 1) - 1
    scale = _scale(x.abs().amax(), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale.float()


def quantize_per_channel(x: torch.Tensor, axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (along ``axis``) symmetric int8 quantization -> (int8
    values, float32 scales with ``axis`` kept and the rest reduced to 1)."""
    x = x.float()
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    scale = _scale(x.abs().amax(dim=red, keepdim=True), 127)
    q = torch.clamp(torch.round(x / scale), -128, 127)
    return q.to(torch.int8), scale


def replace_layers(model: nn.Module, predicate: Callable[[nn.Module], bool],
                   make: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """Replace, in place, every submodule for which ``predicate`` holds by
    ``make(submodule)`` (the ``nn.Module`` walk that stands in for the JAX
    package's ``_replace_layers``).  A root that matches is replaced too:
    use the return value."""
    if predicate(model):
        return make(model)
    for name, child in list(model.named_children()):
        setattr(model, name, replace_layers(child, predicate, make))
    return model


class WeightOnlyInt8Linear(nn.Module):
    """Weight-only int8 linear: ``y = (x @ w_q) * scale (+ bias)`` with
    per-output-channel scales; ``w_q`` is ``[in, out]`` int8.

    Up to :data:`~..ops.decode_matmul.MAX_KERNEL_ROWS` rows (decode) go
    through :func:`~..ops.decode_matmul.int8_stream_matmul`; more rows
    (prefill) take one plain ``torch.matmul`` on the widened weight, with
    the scale and bias in x's dtype, as the JAX package does."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_weight(cls, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None
                    ) -> "WeightOnlyInt8Linear":
        q, s = quantize_per_channel(weight.detach(), axis=1)
        return cls(q, s.reshape(-1),
                   None if bias is None else bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        rows = lead.numel()
        if rows <= MAX_KERNEL_ROWS:
            y = int8_stream_matmul(x.reshape(rows, x.shape[-1]),
                                   self.weight_q, self.scale, self.bias)
            return y.reshape(*lead, -1)
        y = torch.matmul(x, self.weight_q.to(x.dtype))
        y = y * self.scale.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class WeightOnlyInt8Embedding(nn.Module):
    """Int8 embedding table ``[V, H]`` with per-row scales; the tied LM
    head reuses them: ``logits = (h @ w_q^T) * scale``, through the
    pre-transposed ``weight_qT [H, V]`` for the weight-streaming kernel."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32,
                 weight_qT: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("weight_qT", weight_qT)
        self.out_dtype = out_dtype

    @classmethod
    def from_weight(cls, weight: torch.Tensor) -> "WeightOnlyInt8Embedding":
        q, s = quantize_per_channel(weight.detach(), axis=0)
        return cls(q, s.reshape(-1), weight.dtype, q.T.contiguous())

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.weight_q[ids]
        s = self.scale[ids].to(self.out_dtype)
        return rows.to(self.out_dtype) * s[..., None]


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward; the backward passes the gradient
    straight through (in x's dtype)."""

    @staticmethod
    def forward(ctx, x, bits: int):
        ctx.dtype = x.dtype
        q, s = quantize_per_tensor(x, bits)
        return dequantize(q, s)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradients (QAT): float32
    ``dequantize(*quantize_per_tensor(x, bits))``."""
    return _FakeQuant.apply(x, bits)


def _storage_version(t: torch.Tensor) -> tuple:
    """Where ``t``'s data lies and how often it was written in place (an
    inference tensor keeps no count)."""
    return (t.device, t.data_ptr(),
            None if t.is_inference() else t._version)


class QuantizedLinear(nn.Module):
    """Int8-weight linear: ``y = (x_q @ w_q) * (s_x * s_w) + b`` (dynamic
    PTQ).

    ``weight_q`` is int8 ``[in, out]``, ``weight_scale`` float32 ``[1,
    out]`` (per channel) or a scalar, ``bias`` the Linear's.  Beside them
    the layer keeps ``weight_qT``, the int8 ``[out, in]`` (K-major) copy
    the kernel reads, as a non-persistent buffer: the state dict is the
    JAX layer's, and the int8 weight takes twice its bytes.  The copy is
    made when the layer is built, and again by the first call after
    ``weight_q`` was written in place (its ``_version`` moved: a loaded
    state, the JAX bridge of ``weights.py``) or moved (``.to``).

    Each call quantizes x per tensor in float32 over all of it (padded
    rows included, as JAX does), with the scale left on the device, and
    runs the product through :func:`..ops.fused.int8_mm` with no
    ``x_scale`` and ``w_scale = s_x * s_w``: the kernel's ``acc * (s_x *
    s_w)`` is JAX's bit for bit; the kernel also adds the bias in float32
    and writes x's dtype (float32 or bfloat16; another dtype is cast from
    float32), so a call is one launch.  Leading dims of x are flattened
    into the kernel's rows; any shape is taken."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("weight_qT", None, persistent=False)
        self.refresh_weight_qT()

    def refresh_weight_qT(self) -> None:
        """Make ``weight_qT`` again from ``weight_q``, and note which
        ``weight_q`` at which version it copies."""
        self.weight_qT = self.weight_q.t().contiguous()
        self._qT_source = _storage_version(self.weight_q)

    def _weight_qT(self) -> torch.Tensor:
        """``weight_qT``, made again first if ``weight_q`` lies elsewhere
        or was written since the copy."""
        if _storage_version(self.weight_q) != self._qT_source:
            self.refresh_weight_qT()
        return self.weight_qT

    @classmethod
    def from_linear(cls, linear: Linear,
                    per_channel: bool = True) -> "QuantizedLinear":
        w = linear.weight.detach().float()
        q, s = (quantize_per_channel(w, axis=1) if per_channel
                else quantize_per_tensor(w))
        bias = linear.bias
        return cls(q, s, None if bias is None else bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xq, xs = quantize_per_tensor(x.float())
        xq = xq.reshape(-1, x.shape[-1])
        n = self.weight_q.shape[1]
        w_scale = (xs * self.weight_scale).reshape(-1).expand(n)
        out_dtype = (x.dtype if x.dtype in (torch.float32, torch.bfloat16)
                     else torch.float32)
        y = int8_mm(xq, self._weight_qT(), None, w_scale.contiguous(),
                    out_dtype, bias=self.bias, k_major=True)
        return y.to(x.dtype).reshape(*lead, n)


def _is_linear(m: nn.Module) -> bool:
    return isinstance(m, Linear)


def quantize_model(model: nn.Module, per_channel: bool = True) -> nn.Module:
    """Replace every :class:`..nn.layers.Linear` with a
    :class:`QuantizedLinear`, in place (dynamic PTQ); a root Linear is
    replaced too: use the return value."""
    return replace_layers(
        model, _is_linear,
        lambda v: QuantizedLinear.from_linear(v, per_channel))


# ---------------------------------------------------------------------------
# QAT (reference ``paddle.quantization.QAT``: quantize(model) trains with
# fake-quant -> convert(model) emits int8 layers)
# ---------------------------------------------------------------------------
class QATLinear(nn.Module):
    """Linear trained through int8 rounding: weights and activations pass
    :func:`fake_quant` (straight-through) each forward, in float32, and the
    product runs in x's dtype like the Linear this wraps, whose parameters
    it shares; inside :func:`..amp.auto_cast` x is cast to the compute
    dtype first.  The JAX layer's ``_param_specs`` (tensor-parallel
    sharding) carry-over waits for the multi-GPU port."""

    def __init__(self, linear: Linear, weight_bits: int = 8,
                 activation_bits: int = 8):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast_if_enabled(x)
        xq = fake_quant(x.float(), self.activation_bits).to(x.dtype)
        wq = fake_quant(self.weight.float(), self.weight_bits).to(x.dtype)
        y = torch.matmul(xq, wq)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def to_linear(self) -> Linear:
        """The plain :class:`..nn.layers.Linear` over the same
        parameters."""
        out = Linear.__new__(Linear)
        nn.Module.__init__(out)
        out.in_features, out.out_features = self.weight.shape
        out.weight = self.weight
        out.bias = self.bias
        return out


class QAT:
    """Reference ``paddle.quantization.QAT`` surface: ``quantize(model)``
    wraps every Linear for fake-quant training; after training
    ``convert(model)`` replaces the wrappers with int8
    :class:`QuantizedLinear` layers.  Both work in place and return the
    model (a root layer is replaced: use the return value)."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def quantize(self, model: nn.Module) -> nn.Module:
        return replace_layers(
            model, _is_linear,
            lambda v: QATLinear(v, self.weight_bits, self.activation_bits))

    def convert(self, model: nn.Module, per_channel: bool = True
                ) -> nn.Module:
        return replace_layers(
            model, lambda v: isinstance(v, QATLinear),
            lambda v: QuantizedLinear.from_linear(v.to_linear(),
                                                  per_channel))


# -- reference paddle.quantization config/observer surface -------------------
# (python/paddle/quantization/: QuantConfig, PTQ, factory.quanter,
# BaseObserver/BaseQuanter.)  QAT and quantize_model do the work; these
# classes carry the reference's calling convention onto them.
class BaseQuanter(nn.Module):
    """Abstract fake-quant node (reference ``base_quanter.BaseQuanter``)."""

    def forward(self, x):
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        raise NotImplementedError


class BaseObserver(BaseQuanter):
    """Abstract observer (reference ``base_observer.BaseObserver``): a
    quanter that also tracks calibration statistics."""

    def cal_thresholds(self):
        raise NotImplementedError


_QUANTER_REGISTRY = {}


def quanter(name: str):
    """Class decorator registering a quanter under ``name`` and exposing a
    same-named factory in the class's own module (the reference
    ``factory.quanter`` contract: users reach the factory where they
    defined the quanter)."""
    def deco(cls):
        if name == cls.__name__:
            # the class statement would rebind the name right after the
            # decorator returns, shadowing the factory
            raise ValueError(
                f"quanter name {name!r} must differ from the class name "
                "(the reference convention: class FooLayer, factory Foo)")
        _QUANTER_REGISTRY[name] = cls

        class _Factory:
            def __init__(self, *args, **kwargs):
                self._args, self._kwargs = args, kwargs

            def _instance(self, layer=None):
                return cls(*self._args, **self._kwargs)

        _Factory.__name__ = name
        mod = sys.modules.get(cls.__module__)
        if mod is not None:
            if getattr(mod, name, None) is not None \
                    and getattr(mod, name) is not cls:
                raise ValueError(
                    f"quanter name {name!r} already bound in "
                    f"{cls.__module__}; pick a name that is not the "
                    "class name or an existing attribute")
            setattr(mod, name, _Factory)
        cls._factory = _Factory
        return cls

    return deco


class QuantConfig:
    """Reference ``QuantConfig(activation=..., weight=...)``: holds the
    quanter factories and per-layer overrides given to PTQ/QAT."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight
        self._layer_configs = []

    def add_layer_config(self, layer, activation=None, weight=None):
        self._layer_configs.append((layer, activation, weight))

    def add_type_config(self, layer_type, activation=None, weight=None):
        self._layer_configs.append((layer_type, activation, weight))


class PTQ:
    """Post-training quantization entry point (reference ``ptq.PTQ``):
    ``quantize(model)`` is :func:`quantize_model` (dynamic PTQ, which
    already emits the int8 layers), ``convert`` returns the model as it
    is.  ``inplace`` is ignored, as in JAX: both work in place."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Module, inplace: bool = False) -> nn.Module:
        return quantize_model(model)

    def convert(self, model: nn.Module, inplace: bool = False) -> nn.Module:
        return model
