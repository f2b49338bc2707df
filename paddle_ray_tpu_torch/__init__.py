"""paddle_ray_tpu_torch -- the PyTorch / CUDA port of ``paddle_ray_tpu``.

Module paths and names mirror the JAX package so each piece has an obvious
counterpart; inside, it is ordinary PyTorch.  The first slice serves GPT
models through the paged continuous-batching :class:`ServingEngine`, with a
hand-written CUDA kernel (``ops/csrc/paged_attention.cu``) for ragged paged
attention.  The second trains them on one device
(:func:`parallel.build_train_step` with :class:`optimizer.AdamW` and
:func:`models.gpt_loss_fn`), with hand-written CUDA kernels for flash
attention forward and backward (``ops/csrc/flash_attention.cu``).  Later
slices decode with ``generate()`` and int8, train the SD-UNet with fused
GroupNorm kernels, and pretrain BERT and train the ``incubate.nn`` fused
encoder layers with fused dropout-add-LayerNorm kernels
(``ops/csrc/fused.cu``) and the flash kernels' bias, mask and segment
ids; a later one trains gpt3-1.3b with ``MemoryEfficientAdamW``, whose
update is one kernel a parameter (``ops/csrc/me_adamw.cu``), beside the
other optimizers, AMP (:mod:`.amp`) and optimizer-state offload.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
where every kernel's plain PyTorch version runs instead.
"""
from .core.rng import seed
from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device", "seed"]
