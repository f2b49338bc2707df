"""Chip smoke test of the PyTorch / CUDA port (``paddle_ray_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device  -- the card, from ``nvidia-smi`` and torch; exits non-zero
   without CUDA.
2. build   -- builds every kernel source under
   ``paddle_ray_tpu_torch/ops/csrc/`` with ``nvcc`` (one process per
   source, all started together).
3. kernel  -- the paged-attention kernel against its plain PyTorch
   version at the shapes the serving path gives it (float32 ``atol=1e-4``,
   bfloat16 ``atol=2e-2``, null page poisoned), over pools in the model's
   dtype and int8 ones (page 32/64/128, head_dim 64/128, GQA), timed with
   CUDA events beside its bound and one PyTorch library call on the same
   inputs.
4. flash_kernel -- the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions on the same inputs: the training shape
   (B 8, S 1024, H 16, D 64, bf16, causal), float32 causal and full, GQA,
   head_dim 128.  Forward within ``atol`` 1e-4 (float32) / 2e-2
   (bfloat16); gradients within ``max|err| / max|ref|`` 1e-4 / 2e-2.
   Timed beside the bound, the plain version and
   ``scaled_dot_product_attention``.  Then the modes BERT and the fused
   encoder run, non-causal at B 8, S 512, H 16, D 64, bf16: segment ids
   with padding, a ``[B, 1, 1, S]`` mask-bias read in place (its result
   equal to the materialised bias's), a full ``[B, H, S, S]`` bias with
   dbias from the dq kernel; each timed beside its bound and SDPA with the
   same mask.
5. decode_kernel -- the decode kernels against their plain versions:
   fused decode attention at B 8, h 16, d 64 over the 512-row cache of
   ``generate()`` (pos 0, 127, 255, 383; bfloat16, float32 and int8), and
   ``int8_stream_matmul`` at gpt3-350m's decode shapes (8 rows x 1024->3072,
   1024->1024, 1024->4096, 4096->1024, the 1024->50304 head), float32 and
   N = 97; each timed beside its bound and one library call.
6. serve   -- GPT-3 350m (bf16, random weights from seed 0) served by the
   port's ``ServingEngine`` through the 12-request mixed-length workload
   of ``bench.py:bench_serving``; every request must return its full
   budget, and the paged-attention kernel must have been launched once
   per layer per step.
7. check   -- two requests through an engine on a float32 copy of the
   weights, against greedy decoding by plain ``GPT.forward``.
8. serve_int8 -- the same workload with ``kv_cache_dtype="int8"``, every
   other request sampled (temperature 0.8, top_k 50, top_p 0.95, fixed
   seeds); full budgets, the int8 paged kernel launched once per layer per
   step.  Four sampled requests with 8-token prompts served by a fresh
   engine and in reverse order by another draw the same tokens; the
   workload's first four sampled requests resubmitted alone report the
   share of their tokens equal to the 12-request run's.
9. generate -- ``bench.py``'s two generation rows: gpt3-350m, batch 8,
   prompt 128, 256 new tokens, (a) bf16 ``generate()`` and (b)
   ``quantize_for_decode`` + ``kv_cache_dtype="int8"``; one warm-up and two
   timed calls each, with launch counts per call, then a short call of each
   under ``torch.profiler``.
10. generate_check -- a 4-layer float32 model of GPT-3 350m's width: the
   kernels' greedy tokens against ``fused_attention=False`` (dense and
   int8 KV) and the paged layout against the dense one, equal up to a step
   where the reference's top-2 logit gap is below 1e-3, and the threefry
   bits of 4,096 (seed, position) keys equal on the card and the CPU.
11. train  -- the training main path of ``bench.py``'s headline: GPT-3
   350m (bf16 parameters, flash attention, remat off, seq 1024, batch 8
   of ``(ids, ids)``), ``AdamW(1e-4)`` through ``build_train_step``, 2
   warm-up and 10 timed steps; every loss finite, the last below the
   first, each flash kernel launched 24 times a step; then one step under
   ``torch.profiler``.
12. train_check -- a 4-layer float32 model of GPT-3 350m's width (B 2,
   S 512) built twice from one set of weights, flash kernels against
   plain dense attention: step-1 gradients within ``max|err| / max|ref|``
   1e-3 per parameter, three ``AdamW(1e-4)`` losses within ``rtol`` 1e-3.
13. gn_kernel -- the fused GroupNorm forward and backward kernels against
   their plain versions on the same inputs (run after ``decode_kernel``):
   every (rows, C, mode) of the SD-UNet training step at batch 32 in
   bfloat16 (14 shapes; modes act none, act silu, scale+shift+silu), a
   few float32 cases, an odd row count and group counts other than 32.
   Forward within ``atol`` 1e-4 (float32) / 2e-2 plus one bfloat16
   rounding (``rtol`` 2**-8; bfloat16); statistics within 1e-4; gradients
   within ``max|err| / max|ref|`` 1e-4 / 2e-2.  The step's cases timed
   beside the bound, the plain version and
   ``torch.nn.functional.group_norm``, and summed over the step's 56 calls.
14. unet_train -- ``bench.py:bench_unet``'s SD-UNet (base 320, mults
   1/2/4/4, attention at levels 2 and 3, 8 heads, 32 groups, bf16
   parameters, batch 32 of 64x64x4 latents, t in [0, 1000)) through
   ``build_train_step`` with ``AdamW(1e-4)``: 2 warm-up and 10 timed
   steps, every loss finite, the last below the first, each GroupNorm
   kernel launched 56 times a step; images/s, MFU from
   ``FlopCounterMode``'s forward count x 3, then one step under
   ``torch.profiler``.
15. unet_check -- a shallow float32 UNet of SD width (base 320, mults
   1/2, attention at level 1) on the card and as a copy on the CPU (the
   plain versions), TF32 off: forward within ``max|err| / max|ref|``
   1e-4, step-1 gradients within 1e-3 per parameter, three
   ``AdamW(1e-4)`` losses within ``rtol`` 1e-3.
16. dal_kernel -- the fused dropout-add-LayerNorm forward and backward
   kernels against their plain versions (run after ``gn_kernel``) at the
   fused encoder's shape ``[8 x 512, 1024]``: bfloat16 and float32, p 0.1
   and 0, training on and off, an odd row count, with and without the h
   output's cotangent; the keep mask bit-identical to ``keep_mask_plain``
   (h of x = 1, residual 0 is the scaled mask).  y and h within ``atol``
   1e-4 (float32) / 2e-2 plus one bfloat16 rounding step (``rtol`` 2**-7),
   statistics within 1e-4, gradients within ``max|err| / max|ref|`` 1e-4 /
   2e-2.  The encoder's case timed beside the bound, the plain version and
   ``torch.nn.functional.layer_norm`` on h alone (and its autograd
   backward).
17. bert_train -- ``bench.py:bench_bert("bert-large", 512, 8, 10, {},
   zero_stage=0)``: BERT-large (bf16, flash), batch 8 of 512 random ids
   with ``mlm_labels = ids`` and NSP labels 0, ``AdamW(1e-4)`` through
   ``build_train_step``, 2 warm-up and 10 timed steps; every loss finite,
   the last below the first, each flash kernel launched 24 times a step;
   tokens/s, step ms, MFU by bench's ``6 N + 12 L H S`` over 989 TFLOP/s,
   peak memory; then one step under ``torch.profiler``.
18. bert_check -- BERT-large width in float32, 4 layers, batch 2 of 512
   padded to lengths 512 and 333 (segment ids on the flash path), on the
   card and as a copy on the CPU (the plain versions), TF32 off: MLM
   logits within ``max|err| / max|ref|`` 1e-4, step-1 gradients within
   1e-3 per parameter, three ``AdamW(1e-4)`` losses within ``rtol`` 1e-3.
19. encoder_train -- 24 ``FusedTransformerEncoderLayer(1024, 16, 4096,
   dropout_rate=0.1, activation="gelu", attn_dropout_rate=0.0,
   act_dropout_rate=0.0)`` (post-LN), bf16, batch 8 of 512 with a
   ``[8, 1, 1, 512]`` padding mask over lengths 288-512, an MSE loss
   against a seeded target, ``AdamW(1e-4)``, the key ``fold_in(PRNGKey(0),
   step)`` folded with the layer index: 2 warm-up and 10 timed steps,
   losses finite and falling, 48 launches each of the dropout-add-LN
   kernels and 24 of each flash kernel a step; tokens/s and one profiled
   step.
20. int8_mm_kernel -- the int8 matmul kernel against
   ``int8_matmul_plain`` on random int8 values and positive scales,
   ``torch.equal`` in every case: the fused encoder's four linears at M =
   8 x 512 (1024->3072, 1024->1024, 1024->4096, 4096->1024) and
   gpt3-350m's fc1 at 8192 rows, each timed beside its bound, the plain
   version and ``torch._int_mm`` followed by the two scale products (and
   ``torch._int_mm``'s int32 product alone);
   bfloat16 output, the ``QuantizedLinear`` form (``x_scale = 1``),
   ragged M = 4093, N = 97 or 1000, K = 1000 or 1040.
21. ptq_encoder -- ``encoder_train``'s 24-layer stack (same seed, bf16)
   in eval mode, batch 8 of 512 with the padding mask: one warm-up and 5
   timed forwards under ``torch.no_grad()`` in bf16, then
   ``PTQ(QuantConfig())`` and the same in int8 (ms, tokens/s, peak
   memory); per forward 96 ``int8_matmul`` launches (int8), 24 of the
   flash forward, 48 of the dropout-add-LN forward, no backward kernel;
   the int8 output's ``max|err| / max|ref|`` and cosine against the bf16
   one on the valid rows (reported, not gated); one profiled forward of
   each.
22. ptq_check -- a 4-layer float32 stack of that width, TF32 off, batch
   2 of 512 padded to 512 and 333, quantized on the card and as a CPU
   copy (plain versions): equal int8 weights, the first projection and a
   ``QuantizedLinear`` on one shared input equal bit for bit, the outputs
   within ``max|err| / max|ref|`` 0.05 -- the int8 error's own level: a
   last-bit difference that moves one tensor's largest activation moves
   its per-tensor scale (see the phase, which also reports the CPU
   stack's change under a 1e-7 relative input perturbation).
23. qat -- ``QAT().quantize`` on a 4-layer bf16 stack of that width, 5
   ``AdamW(1e-4)`` steps with ``encoder_train``'s loss and keys, losses
   finite and falling; ``QAT().convert`` and one eval forward with 16
   ``int8_matmul`` launches.

Then the card's name and power limit (as ``nvidia-smi`` prints them), the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failure raises, so the script exits non-zero and prints no result.
Long logs (``nvcc -Xptxas -v``) go to ``chiprun_out/``.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # tensor cores, bf16
                  torch.float32: 67e12,     # CUDA cores, fp32
                  torch.int8: 1979e12}      # tensor cores, int8
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

MODEL = "gpt3-350m"
PAGE, MAX_BATCH, SEED = 64, 8, 0
# bench.py's headline training run: batch 8 of seq 1024, AdamW(1e-4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 1024, 1e-4
WARMUP_STEPS, TIMED_STEPS = 2, 10
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# bench.py:bench_unet: the SD-UNet config, batch 32 of 64x64 latents
UNET_CFG = dict(in_channels=4, out_channels=4, base_channels=320,
                channel_mults=(1, 2, 4, 4), attn_levels=(2, 3), num_heads=8,
                groups=32, blocks_per_level=2, upsample="interp")
UNET_BATCH, UNET_IMG, UNET_LR = 32, 64, 1e-4
GN_KERNELS = ("fused_group_norm", "fused_group_norm_bwd")
# bench.py:bench_bert("bert-large", 512, 8, 10, {}, zero_stage=0)
BERT_MODEL, BERT_SEQ, BERT_BATCH, BERT_LR = "bert-large", 512, 8, 1e-4
# the fused encoder: 24 FusedTransformerEncoderLayer of BERT-large width
ENC_LAYERS, ENC_D, ENC_HEADS, ENC_FFN, ENC_RATE = 24, 1024, 16, 4096, 0.1
ENC_BATCH, ENC_SEQ, ENC_LR = 8, 512, 1e-4
ENC_LENGTHS = tuple(int(x) for x in np.linspace(288, 512, ENC_BATCH))
DAL_KERNELS = ("fused_dropout_add_layernorm",
               "fused_dropout_add_layernorm_bwd")
DAL_EPS, DAL_SEED = 1e-5, 12345
# dynamic-PTQ int8 inference of the fused encoder: its four linears at
# M = 8 x 512 rows, (name, K, N); four a layer, 96 a forward
ENC_LINEARS = (("qkv", ENC_D, 3 * ENC_D), ("out_proj", ENC_D, ENC_D),
               ("linear1", ENC_D, ENC_FFN), ("linear2", ENC_FFN, ENC_D))
PTQ_TIMED, QAT_LAYERS, QAT_STEPS = 5, 4, 5
# ptq_check: max|err| / max|ref| of the int8 stack on the card against its
# CPU copy, at the level of the int8 error itself (see phase_ptq_check)
PTQ_CHECK_TOL = 0.05


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` (ms) on the device, with the 50 MB
    L2 flushed before every timed launch: the serving path reads each
    layer's pages cold.  A device-side sleep longer than the host's
    enqueue of ``fn`` sits before the start event, so the events bracket
    the device work alone and not the Python around it (a kernel of a few
    microseconds would otherwise time its wrapper)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # at most 1.98 GHz on an H100 SXM: this many cycles last 2x the enqueue
    sleep_cycles = int(2 * max(host_s, 50e-6) * 1.98e9)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_rows(prof):
    """(name, device us, calls) of the device-side kernel events of a
    ``torch.profiler`` run only: the CPU op rows repeat their kernels'
    device time, and the user-annotation rows (``torch.optim``'s
    ``Optimizer.step#...``) span it."""
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def annotation_spans(prof):
    """(name, us) of the user-annotated ranges on the device timeline:
    from the first kernel launched inside the range to the end of the
    last, gaps included."""
    return [(e.key, e.device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "is_user_annotation", False)]


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # float32 products in full float32, as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from paddle_ray_tpu_torch.ops import _build
    csrc = os.path.join(HERE, "paddle_ray_tpu_torch", "ops", "csrc")
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build_all(names)
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, log in logs.items():
        with open(os.path.join(OUT_DIR, f"nvcc_{name}.log"), "w") as f:
            f.write(log)
    spills = sorted({line.strip() for log in logs.values()
                     for line in log.splitlines()
                     if "spill" in line and not line.strip().startswith(
                         "0 bytes spill")})
    emit("build", kernels=names, seconds=round(build_s, 3),
         spill_lines=spills)


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------
def _attention_case(name, *, dtype, width, q_lens, lengths, h_q=16,
                    h_kv=16, d=64, blocks=32, page=PAGE, q8=False, seed=0):
    """Inputs at the serving path's shapes: 8 slots, pages of ``page`` rows
    scattered over a 1 + 8 * ``blocks`` page pool, page 0 poisoned.  With
    ``q8`` the pool is int8 per (token, head), as the engine writes it."""
    from paddle_ray_tpu_torch.models.generation import _kv_quant
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b = len(q_lens)
    n = 1 + b * blocks
    k = torch.randn(n, page, h_kv, d, generator=g, device="cuda")
    v = torch.randn(n, page, h_kv, d, generator=g, device="cuda")
    perm = torch.randperm(n - 1, generator=g, device="cuda") + 1
    table = perm.reshape(b, blocks).to(torch.int32)
    q = torch.randn(b, width, h_q, d, generator=g, device="cuda")
    if q8:
        (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
        for t in (kq, vq):
            t[0] = 127
        for t in (ks, vs):
            t[0] = 1e4
        pool = (kq, ks[..., 0], vq, vs[..., 0])
    else:
        k[0] = 1e4
        v[0] = 1e4
        pool = (k.to(dtype), v.to(dtype))
    return dict(name=name, q=q.to(dtype), pool=pool, table=table,
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device="cuda"),
                q_lens=torch.tensor(q_lens, dtype=torch.int32,
                                    device="cuda"))


def _attention_bound(c) -> dict:
    """The least time for this call's work: bytes (q and out once, the K/V
    rows the live slots own once -- int8 values plus a float32 scale per
    row and head for an int8 pool --, table and lengths) over the HBM rate,
    and 4 * (visible keys) * h_q * d operations over the peak for q's type;
    the larger of the two."""
    q, pool = c["q"], c["pool"]
    es = q.element_size()
    _, _, h_q, d = q.shape
    h_kv = pool[0].shape[2]
    row_bytes = (d + 4 if len(pool) == 4 else d * es) * h_kv
    lengths = c["lengths"].tolist()
    q_lens = c["q_lens"].tolist()
    rows = sum(ln for ln, ql in zip(lengths, q_lens) if ln > 0 and ql > 0)
    n_bytes = (2 * q.numel() * es + 2 * rows * row_bytes
               + c["table"].numel() * 4 + 2 * len(lengths) * 4)
    keys = sum(ln - ql + i + 1 for ln, ql in zip(lengths, q_lens)
               for i in range(ql) if ln > 0)
    ops = 4 * keys * h_q * d
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _sdpa_inputs(c):
    """The same K/V gathered into contiguous ``[B, h, T, d]`` (outside the
    timed call; an int8 pool dequantised) and the ragged causal mask as a
    boolean ``[B, 1, C, T]``."""
    q, pool, table = c["q"], c["pool"], c["table"]
    b, width, h_q, d = q.shape
    _, page, h_kv, _ = pool[0].shape
    if len(pool) == 4:
        k = (pool[0].float() * pool[1][..., None]).to(q.dtype)
        v = (pool[2].float() * pool[3][..., None]).to(q.dtype)
    else:
        k, v = pool
    t_len = table.shape[1] * page
    kd = k[table.long()].reshape(b, t_len, h_kv, d).transpose(1, 2)
    vd = v[table.long()].reshape(b, t_len, h_kv, d).transpose(1, 2)
    rep = h_q // h_kv
    kd = kd.repeat_interleave(rep, dim=1).contiguous()
    vd = vd.repeat_interleave(rep, dim=1).contiguous()
    t = torch.arange(t_len, device="cuda")
    qi = torch.arange(width, device="cuda")
    ln = c["lengths"].long()[:, None, None]
    ql = c["q_lens"].long()[:, None, None]
    mask = ((t[None, None, :] <= ln - ql + qi[None, :, None])
            & (qi[None, :, None] < ql))
    # SDPA has no zero-row convention: give dead rows key 0 (timing only)
    mask[:, :, 0] |= ~mask.any(-1)
    return q.transpose(1, 2).contiguous(), kd, vd, mask[:, None]


def phase_kernel() -> dict:
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention, paged_ragged_attention_plain)
    decode = dict(width=8, q_lens=[1] * 7 + [0],
                  lengths=[1, 63, 64, 65, 700, 2048, 1500, 0])
    mixed = dict(width=128, q_lens=[128, 1, 1, 1, 1, 1, 1, 0],
                 lengths=[1664, 1, 64, 65, 700, 2048, 1000, 0])
    decode_2048 = dict(width=1, q_lens=[1] * 8, lengths=[2048] * 8)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            _attention_case(f"decode_{tag}", dtype=dtype, **decode),
            _attention_case(f"decode_gqa_{tag}", dtype=dtype, h_kv=8,
                            **decode),
            _attention_case(f"mixed_{tag}", dtype=dtype, **mixed),
            _attention_case(f"mixed_gqa_{tag}", dtype=dtype, h_kv=8,
                            **mixed),
            _attention_case(f"decode_q8_{tag}", dtype=dtype, q8=True,
                            **decode),
            _attention_case(f"mixed_gqa_q8_{tag}", dtype=dtype, h_kv=8,
                            q8=True, **mixed),
        ]
    cases += [
        _attention_case("decode_q8_page32_d128_bf16", dtype=torch.bfloat16,
                        q8=True, page=32, d=128, h_q=8, h_kv=8, blocks=64,
                        **decode),
        _attention_case("decode_gqa_q8_page128_f32", dtype=torch.float32,
                        q8=True, page=128, h_kv=8, blocks=16, **decode),
        _attention_case("decode_2048_bf16", dtype=torch.bfloat16,
                        **decode_2048),
        _attention_case("decode_2048_q8_bf16", dtype=torch.bfloat16,
                        q8=True, **decode_2048),
    ]
    results = {}
    for c in cases:
        scale = 1.0 / c["q"].shape[-1] ** 0.5
        args = (c["q"], c["pool"], c["table"], c["lengths"], c["q_lens"])
        got = paged_ragged_attention(*args, scale=scale)
        torch.cuda.synchronize()
        want = paged_ragged_attention_plain(*args, scale=scale)
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[c["q"].dtype]
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"{c['name']}: kernel vs plain max_abs_err "
                                 f"{err} > {tol}")
        for b, ql in enumerate(c["q_lens"].tolist()):
            if not bool((got[b, ql:] == 0).all()):
                raise AssertionError(f"{c['name']}: slot {b} pad rows not 0")
        qs, kd, vd, mask = _sdpa_inputs(c)
        r = {
            "max_abs_err": err, "tol": tol, "q8": len(c["pool"]) == 4,
            "ms": time_ms(lambda: paged_ragged_attention(*args, scale=scale)),
            "plain_ms": time_ms(lambda: paged_ragged_attention_plain(
                *args, scale=scale), iters=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, scale=scale)),
            **_attention_bound(c),
        }
        results[c["name"]] = r
        pool = c["pool"]
        emit("kernel", kernel="paged_ragged_attention", case=c["name"],
             shape=list(c["q"].shape), page=pool[0].shape[1],
             h_kv=pool[0].shape[2], kv_dtype=str(pool[0].dtype),
             lengths=c["lengths"].tolist(), q_lens=c["q_lens"].tolist(), **r)
        del qs, kd, vd, mask
    return results


# ---------------------------------------------------------------------------
# 4. the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------
# name, B, S, H, Hkv, D, dtype, causal; the first is the training path's
FLASH_CASES = (
    ("train_bf16", TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, torch.bfloat16, True),
    ("causal_f32", 2, 512, 16, 16, 64, torch.float32, True),
    ("full_f32", 2, 512, 16, 16, 64, torch.float32, False),
    ("gqa_hkv4_f32", 2, 512, 16, 4, 64, torch.float32, True),
    ("d128_bf16", 2, 512, 8, 8, 128, torch.bfloat16, True),
)


def _flash_bound(kind, b, s, h, hkv, d, dtype, causal, extra_bytes=0) -> dict:
    """The least time for one kernel's work at this shape: its products
    (forward 2, dq 3, dk/dv 4 ``[S, D] x [D, S]``-shaped ones, each 2 *
    pairs * D operations per head, pairs the visible (row, key) pairs)
    over the peak for the inputs' type, against its inputs and outputs
    read and written once over the HBM rate (``extra_bytes``: a bias or
    segment ids read, dbias written); the larger of the two."""
    pairs = s * (s + 1) // 2 if causal else s * s
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    ops = 2 * products * pairs * d * b * h
    es = torch.tensor([], dtype=dtype).element_size()
    nq, nkv, row = b * s * h * d * es, b * s * hkv * d * es, b * h * s * 4
    n_bytes = {"fwd": 2 * nq + 2 * nkv + row,             # q k v -> o lse
               "dq": 3 * nq + 2 * nkv + 2 * row,          # q k v do lse delta -> dq
               "dkv": 2 * nq + 4 * nkv + 2 * row}[kind]   # q k v do lse delta -> dk dv
    n_bytes += extra_bytes
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def phase_flash_kernel() -> dict:
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.flash_attention import (
        _fold_heads, flash_backward_dkv, flash_backward_dkv_plain,
        flash_backward_dq, flash_backward_dq_plain, flash_forward,
        flash_forward_plain)
    results = {}
    for name, b, s, h, hkv, d, dtype, causal in FLASH_CASES:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        shape_q, shape_kv = (b, s, h, d), (b, s, hkv, d)
        q, do = (torch.randn(shape_q, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(shape_kv, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        qf, kf, vf, dof = (_fold_heads(t) for t in (q, k, v, do))
        kw = dict(causal=causal, scale=1.0 / d ** 0.5)
        tol = TOL[dtype]

        o, lse = flash_forward(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_forward_plain(qf, kf, vf, **kw)
        delta = (o_ref.float() * dof.float()).sum(-1)
        bwd = (qf, kf, vf, dof, lse_ref, delta)
        dq = flash_backward_dq(*bwd, **kw)
        dk, dv = flash_backward_dkv(*bwd, **kw)
        torch.cuda.synchronize()
        dq_ref = flash_backward_dq_plain(*bwd, **kw)
        dk_ref, dv_ref = flash_backward_dkv_plain(*bwd, **kw)
        err = {"fwd": max(float((o.float() - o_ref.float()).abs().max()),
                          float((lse - lse_ref).abs().max())),
               "dq": float((dq.float() - dq_ref.float()).abs().max()),
               "dkv": max(float((dk.float() - dk_ref.float()).abs().max()),
                          float((dv.float() - dv_ref.float()).abs().max()))}
        rel = {"dq": _rel_err(dq, dq_ref),
               "dkv": max(_rel_err(dk, dk_ref), _rel_err(dv, dv_ref))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse, dq, dk, dv))
        if not (finite and err["fwd"] <= tol and rel["dq"] <= tol
                and rel["dkv"] <= tol):
            raise AssertionError(f"flash {name}: kernel vs plain: forward "
                                 f"max_abs_err {err['fwd']}, gradient "
                                 f"rel_err {rel} (tolerance {tol})")

        # yardstick: SDPA on [B, H, S, D] (the moves and the GQA
        # repetition are not timed); its backward is fwd+bwd minus fwd
        rep = h // hkv
        qh, doh = (t.transpose(1, 2).contiguous() for t in (q, do))
        kh, vh = (t.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
                  for t in (k, v))
        sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
            *a, is_causal=causal, scale=kw["scale"])
        lib_fwd = time_ms(lambda: sdpa(qh, kh, vh))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves), leaves, doh))
        r = {
            "fwd": {"ms": time_ms(lambda: flash_forward(qf, kf, vf, **kw)),
                    "plain_ms": time_ms(lambda: flash_forward_plain(
                        qf, kf, vf, **kw), iters=5),
                    "library_ms": lib_fwd},
            "dq": {"ms": time_ms(lambda: flash_backward_dq(*bwd, **kw)),
                   "plain_ms": time_ms(lambda: flash_backward_dq_plain(
                       *bwd, **kw), iters=5),
                   "library_ms": lib_fwd_bwd - lib_fwd},
            "dkv": {"ms": time_ms(lambda: flash_backward_dkv(*bwd, **kw)),
                    "plain_ms": time_ms(lambda: flash_backward_dkv_plain(
                        *bwd, **kw), iters=5),
                    "library_ms": lib_fwd_bwd - lib_fwd},
        }
        for kind in r:
            r[kind].update(max_abs_err=err[kind], **_flash_bound(
                kind, b, s, h, hkv, d, dtype, causal))
            if kind in rel:
                r[kind]["rel_err"] = rel[kind]
        results[name] = r
        emit("flash_kernel", case=name, shape=[b, s, h, d], h_kv=hkv,
             dtype=str(dtype), causal=causal, tol=tol,
             library="scaled_dot_product_attention (dq and dkv entries: "
                     "its backward, for the two kernels together)", **r)
        del q, k, v, do, qf, kf, vf, dof, qh, kh, vh, doh, leaves
    results.update(_flash_mode_cases())
    return results


# B 8, S 512, H 16, D 64, bf16, non-causal: the shape of BERT-large's and the
# fused encoder's attention, with the masking each runs
FLASH_MODES = ("segments_bf16", "mask_bias_bf16", "bias_dbias_bf16")


def _flash_mode_cases() -> dict:
    """The flash kernels with segment ids (padding over the encoder's
    lengths), a ``[B, 1, 1, S]`` mask-bias read in place (equal to the
    materialised bias) and a full float32 bias with dbias, against the
    plain versions; each timed beside its bound, the plain version and
    SDPA with the same mask (a boolean mask, or the bias as a float mask
    without its gradient)."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.flash_attention import (
        _fold_heads, flash_backward_dkv, flash_backward_dkv_plain,
        flash_backward_dq, flash_backward_dq_plain, flash_forward,
        flash_forward_plain)
    b, s, h, d, dtype = ENC_BATCH, ENC_SEQ, ENC_HEADS, 64, torch.bfloat16
    tol = TOL[dtype]
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    qf, kf, vf, dof = (_fold_heads(t) for t in (q, k, v, do))
    valid = (torch.arange(s, device="cuda")[None, :]
             < torch.tensor(ENC_LENGTHS, device="cuda")[:, None])
    seg = valid.to(torch.int32).contiguous()
    mask_bias = torch.where(valid, 0.0, -1e30)[:, None, None, :].float()
    full_bias = torch.randn(b, h, s, s, generator=g, device="cuda")
    modes = {
        "segments_bf16": (dict(segment_ids=(seg, seg)),
                          seg[:, None, :, None] == seg[:, None, None, :],
                          2 * b * s * 4),
        "mask_bias_bf16": (dict(bias=mask_bias.expand(b, h, s, s)),
                           valid[:, None, None, :], b * s * 4),
        "bias_dbias_bf16": (dict(bias=full_bias), full_bias.to(dtype),
                            b * h * s * s * 4),
    }
    results = {}
    for name, (extra, sdpa_mask, extra_bytes) in modes.items():
        kw = dict(causal=False, scale=1.0 / d ** 0.5, **extra)
        need = name == "bias_dbias_bf16"
        o, lse = flash_forward(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_forward_plain(qf, kf, vf, **kw)
        delta = (o_ref.float() * dof.float()).sum(-1)
        bwd = (qf, kf, vf, dof, lse_ref, delta)
        dq = flash_backward_dq(*bwd, need_dbias=need, **kw)
        dk, dv = flash_backward_dkv(*bwd, **kw)
        torch.cuda.synchronize()
        dq_ref = flash_backward_dq_plain(*bwd, need_dbias=need, **kw)
        dk_ref, dv_ref = flash_backward_dkv_plain(*bwd, **kw)
        rel = {}
        if need:
            (dq, dbias), (dq_ref, dbias_ref) = dq, dq_ref
            rel["dbias"] = _rel_err(dbias, dbias_ref)
        err = {"fwd": max(float((o.float() - o_ref.float()).abs().max()),
                          float((lse - lse_ref).abs().max())),
               "dq": float((dq.float() - dq_ref.float()).abs().max()),
               "dkv": max(float((dk.float() - dk_ref.float()).abs().max()),
                          float((dv.float() - dv_ref.float()).abs().max()))}
        rel.update(dq=_rel_err(dq, dq_ref),
                   dkv=max(_rel_err(dk, dk_ref), _rel_err(dv, dv_ref)))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse, dq, dk, dv))
        same_as_materialised = None
        if name == "mask_bias_bf16":
            o_mat, lse_mat = flash_forward(
                qf, kf, vf, **dict(kw, bias=extra["bias"].contiguous()))
            same_as_materialised = bool(torch.equal(o_mat, o)
                                        and torch.equal(lse_mat, lse))
        if not (finite and err["fwd"] <= tol and max(rel.values()) <= tol
                and same_as_materialised is not False):
            raise AssertionError(
                f"flash {name}: kernel vs plain: forward max_abs_err "
                f"{err['fwd']}, gradient rel_err {rel} (tolerance {tol}), "
                f"equal to the materialised bias: {same_as_materialised}")
        qh, kh, vh, doh = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
            *a, attn_mask=sdpa_mask, scale=kw["scale"])
        lib_fwd = time_ms(lambda: sdpa(qh, kh, vh))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves), leaves, doh))
        r = {
            "fwd": {"ms": time_ms(lambda: flash_forward(qf, kf, vf, **kw)),
                    "plain_ms": time_ms(lambda: flash_forward_plain(
                        qf, kf, vf, **kw), iters=5),
                    "library_ms": lib_fwd},
            "dq": {"ms": time_ms(lambda: flash_backward_dq(
                       *bwd, need_dbias=need, **kw)),
                   "plain_ms": time_ms(lambda: flash_backward_dq_plain(
                       *bwd, need_dbias=need, **kw), iters=5),
                   "library_ms": lib_fwd_bwd - lib_fwd},
            "dkv": {"ms": time_ms(lambda: flash_backward_dkv(*bwd, **kw)),
                    "plain_ms": time_ms(lambda: flash_backward_dkv_plain(
                        *bwd, **kw), iters=5),
                    "library_ms": lib_fwd_bwd - lib_fwd},
        }
        for kind in r:
            kind_bytes = extra_bytes + (b * h * s * s * 4
                                        if need and kind == "dq" else 0)
            r[kind].update(max_abs_err=err[kind], rel_err=rel.get(kind),
                           **_flash_bound(kind, b, s, h, h, d, dtype, False,
                                          kind_bytes))
        results[name] = r
        emit("flash_kernel", case=name, shape=[b, s, h, d], h_kv=h,
             dtype=str(dtype), causal=False, tol=tol,
             lengths=list(ENC_LENGTHS), dbias_rel_err=rel.get("dbias"),
             equal_to_materialised_bias=same_as_materialised,
             library="scaled_dot_product_attention with the same mask "
                     "(dq and dkv entries: its backward, for the two "
                     "kernels together, without dbias)", **r)
        del o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref, leaves
    return results


# ---------------------------------------------------------------------------
# 5. the decode kernels against their plain versions
# ---------------------------------------------------------------------------
# generate()'s cache for prompt 128 + 256 new tokens, aligned to its 256-row
# block; the positions its decode steps attend up to
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 128, 256
DEC_CACHE_T = 512
DEC_POSITIONS = (0, 127, 255, 383)
# gpt3-350m's decode linears (K, N, has bias) and the tied LM head
DEC_LINEARS = (("qkv", 1024, 3072, True), ("out", 1024, 1024, True),
               ("fc1", 1024, 4096, True), ("fc2", 4096, 1024, True),
               ("head", 1024, 50304, False))


def _decode_attention_bound(b, h, n_live, d, dtype, q8) -> dict:
    """Least time: q and out once, the live K/V rows once (int8: values
    plus a float32 scale per row), 4 * rows * d operations per (b, h)
    over the peak for q's type."""
    es = torch.tensor([], dtype=dtype).element_size()
    row = d + 4 if q8 else d * es
    n_bytes = 2 * b * h * d * es + 2 * b * h * n_live * row
    ops = 4 * b * h * n_live * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _matmul_bound(b, k, n, dtype, bias) -> dict:
    """Least time: x, the int8 weight, the scales (and bias) read once, the
    output written once; 2 * B * K * N operations over the peak for x's
    type."""
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = b * k * es + k * n + n * 4 + (n * 4 if bias else 0) \
        + b * n * es
    ops = 2 * b * k * n
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _decode_attention_cases():
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.models.generation import _kv_quant
    from paddle_ray_tpu_torch.ops.decode_attention import (
        fused_decode_attention, fused_decode_attention_plain,
        fused_decode_attention_q8_plain)
    b, h, d = GEN_BATCH, 16, 64
    scale = 1.0 / d ** 0.5
    results = {}
    for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32),
                        ("q8", torch.bfloat16)):
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        q = torch.randn(b, h, 1, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, h, DEC_CACHE_T, d, generator=g, device="cuda")
        v = torch.randn(b, h, DEC_CACHE_T, d, generator=g, device="cuda")
        if kind == "q8":
            (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
            cache = (kq, ks, vq, vs)
            plain = fused_decode_attention_q8_plain
            kd = (kq.float() * ks).to(dtype)
            vd = (vq.float() * vs).to(dtype)
        else:
            cache = (k.to(dtype), v.to(dtype))
            plain = fused_decode_attention_plain
            kd, vd = cache
        for pos in DEC_POSITIONS:
            got = fused_decode_attention(q, cache, pos, scale=scale)
            torch.cuda.synchronize()
            want = plain(q, cache, pos, scale=scale)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            if not (err <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"decode attention {kind} pos {pos}: "
                                     f"max_abs_err {err} > {tol}")
            ks_, vs_ = (kd[:, :, :pos + 1].contiguous(),
                        vd[:, :, :pos + 1].contiguous())
            r = {"max_abs_err": err, "tol": tol,
                 "ms": time_ms(lambda: fused_decode_attention(
                     q, cache, pos, scale=scale)),
                 "plain_ms": time_ms(lambda: plain(q, cache, pos,
                                                   scale=scale), iters=5),
                 "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                     q, ks_, vs_, scale=scale)),
                 **_decode_attention_bound(b, h, pos + 1, d, dtype,
                                           kind == "q8")}
            results[f"{kind}_pos{pos}"] = r
            emit("decode_kernel", kernel="fused_decode_attention",
                 case=f"{kind}_pos{pos}", shape=[b, h, DEC_CACHE_T, d],
                 q_dtype=str(dtype), cache_dtype=str(cache[0].dtype),
                 library="scaled_dot_product_attention over [B, h, pos+1, d]"
                 + (" (dequantised cache)" if kind == "q8" else ""), **r)
    return results


def _matmul_cases():
    from paddle_ray_tpu_torch.ops.decode_matmul import (
        int8_stream_matmul, int8_stream_matmul_plain)
    from paddle_ray_tpu_torch.quantization import quantize_per_channel
    cases = [(name, GEN_BATCH, k, n, bias, torch.bfloat16)
             for name, k, n, bias in DEC_LINEARS]
    cases += [("out_no_bias", GEN_BATCH, 1024, 1024, False, torch.bfloat16),
              ("n97", GEN_BATCH, 1024, 97, True, torch.bfloat16),
              ("qkv_f32", GEN_BATCH, 1024, 3072, True, torch.float32),
              ("rows1", 1, 1024, 4096, True, torch.bfloat16),
              ("rows128", 128, 1024, 1024, True, torch.bfloat16)]
    results = {}
    for name, b, k, n, with_bias, dtype in cases:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        # gpt3-350m-like magnitudes: weights N(0, 0.02), activations of
        # unit scale (half for the 4096-wide fc2 input)
        w = 0.02 * torch.randn(k, n, generator=g, device="cuda")
        w_q, scale = quantize_per_channel(w, axis=1)
        scale = scale.reshape(-1)
        x = (torch.randn(b, k, generator=g, device="cuda")
             * (0.5 if k > 1024 else 1.0)).to(dtype)
        bias = (0.02 * torch.randn(n, generator=g, device="cuda")).to(dtype) \
            if with_bias else None
        got = int8_stream_matmul(x, w_q, scale, bias)
        torch.cuda.synchronize()
        want = int8_stream_matmul_plain(x, w_q, scale, bias)
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype]
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"int8_stream_matmul {name}: max_abs_err "
                                 f"{err} > {tol}")

        def library():
            y = torch.matmul(x, w_q.to(dtype)) * scale.to(dtype)
            return y + bias if bias is not None else y
        r = {"max_abs_err": err, "tol": tol,
             "ms": time_ms(lambda: int8_stream_matmul(x, w_q, scale, bias)),
             "plain_ms": time_ms(lambda: int8_stream_matmul_plain(
                 x, w_q, scale, bias), iters=5),
             "library_ms": time_ms(library),
             **_matmul_bound(b, k, n, dtype, with_bias)}
        results[name] = r
        emit("decode_kernel", kernel="int8_stream_matmul", case=name,
             shape=[b, k, n], dtype=str(dtype), bias=with_bias,
             library="torch.matmul(x, w_q.to(x.dtype)) * scale (+ bias)",
             **r)
    return results


def phase_decode_kernel() -> dict:
    return {"attention": _decode_attention_cases(),
            "matmul": _matmul_cases()}


# ---------------------------------------------------------------------------
# 13. the GroupNorm kernels against their plain versions
# ---------------------------------------------------------------------------
# mode -> (act, scale+shift); "mod" is a ResBlock's norm2
GN_MODES = {"none": ("none", False), "silu": ("silu", False),
            "mod": ("silu", True)}
GN_EPS = 1e-5


def unet_gn_calls(cfg=UNET_CFG, img=UNET_IMG):
    """(rows, C, mode) of each fused GroupNorm call of one UNet forward,
    in order, walking ``models/unet.py``'s structure: a ResBlock's norm1
    ("silu") and norm2 ("mod"), an AttnBlock's norm ("none"), the output
    norm ("silu")."""
    ch, mults = cfg["base_channels"], cfg["channel_mults"]
    attn, per = cfg["attn_levels"], cfg["blocks_per_level"]
    calls, chans, cin = [], [ch], ch
    last = len(mults) - 1

    def block(rows, c_in, c_out, lvl):
        calls.extend([(rows, c_in, "silu"), (rows, c_out, "mod")])
        if lvl in attn:
            calls.append((rows, c_out, "none"))

    for lvl, mult in enumerate(mults):
        rows = (img >> lvl) ** 2
        for _ in range(per):
            block(rows, cin, ch * mult, lvl)
            cin = ch * mult
            chans.append(cin)
        if lvl != last:
            chans.append(cin)
    rows = (img >> last) ** 2
    calls.extend([(rows, cin, "silu"), (rows, cin, "mod"),
                  (rows, cin, "none"), (rows, cin, "silu"),
                  (rows, cin, "mod")])
    for lvl, mult in reversed(list(enumerate(mults))):
        rows = (img >> lvl) ** 2
        for _ in range(per + 1):
            block(rows, cin + chans.pop(), ch * mult, lvl)
            cin = ch * mult
    calls.append((img * img, cin, "silu"))
    return calls


def _gn_inputs(n, rows, c, mod, dtype):
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = (1.5 * r(n, rows, c) + 0.5).to(dtype)
    w, b = (1.0 + 0.2 * r(c)).to(dtype), (0.2 * r(c)).to(dtype)
    s = t = None
    if mod:
        s, t = (0.3 * r(n, c)).to(dtype), (0.3 * r(n, c)).to(dtype)
    return x, w, b, s, t, r(n, rows, c).to(dtype)


def _gn_bound(kind, n, rows, c, groups, dtype, mode) -> dict:
    """The least time: bytes -- forward x read and y written, backward x
    and dy read and dx written, each once, plus the parameters, the
    statistics and the float32 gradients of the parameters -- over the HBM
    rate, against the float32 operations a pass does per element (forward
    6, +4 for SiLU; backward 12, +10 for SiLU, +5 for the modulation) over
    the float32 CUDA-core peak (the arithmetic is float32 whatever x's
    type); the larger of the two."""
    act, mod = GN_MODES[mode]
    es = torch.tensor([], dtype=dtype).element_size()
    elems = n * rows * c
    params = 2 * c * es + (2 * n * c * es if mod else 0) + 2 * n * groups * 4
    if kind == "fwd":
        n_bytes = 2 * elems * es + params
        ops = elems * (6 + (4 if act == "silu" else 0))
    else:
        n_bytes = (3 * elems * es + params + 2 * c * 4
                   + (2 * n * c * 4 if mod else 0))
        ops = elems * (12 + (10 if act == "silu" else 0) + (5 if mod else 0))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _gn_case(name, n, rows, c, groups, mode, dtype, timed) -> dict:
    """One case: the kernels against the plain versions on the same
    inputs (the backward from the plain forward's statistics), and with
    ``timed`` each timed beside its bound, the plain version and
    ``torch.nn.functional.group_norm`` on the channels-last NCHW view."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.groupnorm import (
        fused_group_norm_bwd, fused_group_norm_bwd_plain, fused_group_norm_fwd,
        fused_group_norm_fwd_plain)
    act, mod = GN_MODES[mode]
    x, w, b, s, t, dy = _gn_inputs(n, rows, c, mod, dtype)
    kw = dict(groups=groups, act=act)
    y, mu, rs = fused_group_norm_fwd(x, w, b, s, t, epsilon=GN_EPS, **kw)
    torch.cuda.synchronize()
    y_ref, mu_ref, rs_ref = fused_group_norm_fwd_plain(
        x, w, b, s, t, epsilon=GN_EPS, **kw)
    bwd = (x, w, b, s, t, mu_ref, rs_ref, dy)
    got = fused_group_norm_bwd(*bwd, **kw)
    torch.cuda.synchronize()
    want = fused_group_norm_bwd_plain(*bwd, **kw)
    tol = TOL[dtype]
    # bfloat16: atol plus one rounding of the output type (a value that the
    # two float32 paths put on either side of a rounding boundary)
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    fwd_err = float((y.float() - y_ref.float()).abs().max())
    stat_err = max(float((mu - mu_ref).abs().max()),
                   float((rs - rs_ref).abs().max()))
    bwd_abs = max(float((a.float() - e.float()).abs().max())
                  for a, e in zip(got, want) if e is not None)
    bwd_rel = {k: _rel_err(a, e) for k, a, e in zip(
        ("dx", "dweight", "dbias", "dscale", "dshift"), got, want)
        if e is not None}
    finite = all(bool(torch.isfinite(a).all()) for a in (y, mu, rs, *got)
                 if a is not None)
    if not (finite and torch.allclose(y.float(), y_ref.float(), rtol=rtol,
                                      atol=tol)
            and stat_err <= 1e-4 and max(bwd_rel.values()) <= tol):
        raise AssertionError(
            f"group norm {name}: kernel vs plain: forward max_abs_err "
            f"{fwd_err}, statistics {stat_err}, gradients rel_err {bwd_rel} "
            f"(tolerance {tol})")
    r = {"fwd": {"max_abs_err": fwd_err, "stat_err": stat_err,
                 **_gn_bound("fwd", n, rows, c, groups, dtype, mode)},
         "bwd": {"max_abs_err": bwd_abs, "rel_err": bwd_rel,
                 **_gn_bound("bwd", n, rows, c, groups, dtype, mode)}}
    if timed:
        xv = x.view(n, rows, 1, c).permute(0, 3, 1, 2)
        dyv = dy.view(n, rows, 1, c).permute(0, 3, 1, 2)
        lib_fwd = time_ms(lambda: F.group_norm(xv, groups, w, b, GN_EPS))
        leaves = [a.detach().requires_grad_() for a in (xv, w, b)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            F.group_norm(leaves[0], groups, leaves[1], leaves[2], GN_EPS),
            leaves, dyv))
        r["fwd"].update(
            ms=time_ms(lambda: fused_group_norm_fwd(
                x, w, b, s, t, epsilon=GN_EPS, **kw)),
            plain_ms=time_ms(lambda: fused_group_norm_fwd_plain(
                x, w, b, s, t, epsilon=GN_EPS, **kw), iters=5),
            library_ms=lib_fwd)
        r["bwd"].update(
            ms=time_ms(lambda: fused_group_norm_bwd(*bwd, **kw)),
            plain_ms=time_ms(lambda: fused_group_norm_bwd_plain(*bwd, **kw),
                             iters=5),
            library_ms=lib_fwd_bwd - lib_fwd)
    emit("gn_kernel", case=name, shape=[n, rows, c], groups=groups,
         mode=mode, dtype=str(dtype), tol=tol, rtol=rtol, timed=timed,
         library="torch.nn.functional.group_norm on the channels-last NCHW "
                 "view: GroupNorm alone, without the modulation or SiLU "
                 "(bwd: its autograd backward)", **r)
    return r


def phase_gn_kernel() -> dict:
    """The UNet step's (rows, C, mode) calls at batch 32 in bfloat16,
    timed; the other modes at the step's shapes, checked; float32 cases;
    an odd row count and group counts other than 32 (2 groups: 320
    channels a group, more than a block's 256 threads)."""
    calls = unet_gn_calls()
    step_cases = sorted(set(calls), key=lambda k: (-k[0], k[1], k[2]))
    shapes = sorted({(rows, c) for rows, c, _ in calls}, reverse=True)
    groups = UNET_CFG["groups"]
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    for rows, c, mode in step_cases:
        results[(rows, c, mode)] = _gn_case(
            f"unet_{rows}x{c}_{mode}_bf16", UNET_BATCH, rows, c, groups,
            mode, bf16, timed=True)
    for rows, c in shapes:
        for mode in GN_MODES:
            if (rows, c, mode) not in results:
                _gn_case(f"unet_{rows}x{c}_{mode}_bf16", UNET_BATCH, rows, c,
                         groups, mode, bf16, timed=False)
    for name, n, rows, c, g, mode, dtype in (
            ("f32_4096x320_mod", UNET_BATCH, 4096, 320, 32, "mod", f32),
            ("f32_256x1280_none", UNET_BATCH, 256, 1280, 32, "none", f32),
            ("f32_64x2560_silu", UNET_BATCH, 64, 2560, 32, "silu", f32),
            ("odd_rows_63x640_g16_mod_bf16", UNET_BATCH, 63, 640, 16, "mod",
             bf16),
            ("g2_cpg320_1024x640_silu_f32", 8, 1024, 640, 2, "silu", f32),
            ("g4_cpg10_4095x40_mod_bf16", 4, 4095, 40, 4, "mod", bf16)):
        _gn_case(name, n, rows, c, g, mode, dtype, timed=dtype == f32)
    # the step's 56 calls of each kernel, summed
    step = {kind: {k: sum(results[call][kind][k] for call in calls)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for kind in ("fwd", "bwd")}
    emit("gn_kernel_step", calls_per_step=len(calls),
         distinct_shapes=len(shapes), distinct_cases=len(step_cases),
         **step)
    return {"cases": results, "step": step, "calls": len(calls)}


# ---------------------------------------------------------------------------
# 16. the fused dropout-add-LayerNorm kernels against their plain versions
# ---------------------------------------------------------------------------
def _dal_bound(kind, rows, h, dtype, dh2) -> dict:
    """The least time: bytes -- forward x and residual read, y and h
    written; backward h, dy (and dh2 when given) read, dx and dres
    written; each once, plus the parameters, the row statistics and the
    float32 dweight / dbias -- over the HBM rate, against the float32
    operations a pass does per element (forward 10, backward 16; the hash
    is integer work, not counted) over the float32 CUDA-core peak; the
    larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    elems = rows * h
    if kind == "fwd":
        n_bytes = 4 * elems * es + 2 * h * es + 2 * rows * 4
        ops = 10 * elems
    else:
        n_bytes = ((4 + int(dh2)) * elems * es + h * es + 2 * rows * 4
                   + 2 * h * 4)
        ops = 16 * elems
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _dal_case(name, rows, h, dtype, p, training, dh2, timed) -> dict:
    """One case: the kernels against the plain versions on the same inputs
    (the backward from the plain forward's h and statistics), the keep
    mask bit for bit, and with ``timed`` each kernel timed beside its
    bound, the plain version and ``torch.nn.functional.layer_norm`` on h
    (the nearest library call: LayerNorm alone; bwd its autograd
    backward)."""
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops.fused import (
        dal_backward, dal_backward_plain, dal_forward, dal_forward_plain,
        keep_mask_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + rows)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x, res, dy = (r(rows, h).to(dtype) for _ in range(3))
    d2 = r(rows, h).to(dtype) if dh2 else None
    w, b = (1.0 + 0.2 * r(h)).to(dtype), (0.2 * r(h)).to(dtype)
    kw = dict(p=p, training=training)
    out = dal_forward(x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw)
    torch.cuda.synchronize()
    ref = dal_forward_plain(x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw)
    bwd = (ref[1], ref[2], ref[3], w, dy, d2, DAL_SEED)
    got = dal_backward(*bwd, **kw)
    torch.cuda.synchronize()
    want = dal_backward_plain(*bwd, **kw)
    tol = TOL[dtype]
    # bfloat16: atol plus one rounding step of the output type
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    fwd_err = max(float((a.float() - e.float()).abs().max())
                  for a, e in zip(out[:2], ref[:2]))
    stat_err = max(float((a - e).abs().max())
                   for a, e in zip(out[2:], ref[2:]))
    bwd_rel = {k: _rel_err(a, e) for k, a, e in zip(
        ("dx", "dres", "dweight", "dbias"), got, want)}
    bwd_abs = max(float((a.float() - e.float()).abs().max())
                  for a, e in zip(got, want))
    mask_same = None
    if training and p > 0.0:
        ones = torch.ones(rows, h, dtype=dtype, device="cuda")
        hm = dal_forward(ones, torch.zeros_like(ones),
                         torch.ones(h, dtype=dtype, device="cuda"),
                         torch.zeros(h, dtype=dtype, device="cuda"),
                         DAL_SEED, epsilon=DAL_EPS, **kw)[1]
        keep = keep_mask_plain((rows, h), p, DAL_SEED, device="cuda")
        mask_same = bool(torch.equal(hm != 0, keep != 0))
    finite = all(bool(torch.isfinite(a).all()) for a in (*out, *got))
    if not (finite and mask_same is not False
            and all(torch.allclose(a.float(), e.float(), rtol=rtol, atol=tol)
                    for a, e in zip(out[:2], ref[:2]))
            and stat_err <= 1e-4 and max(bwd_rel.values()) <= tol):
        raise AssertionError(
            f"dal {name}: kernel vs plain: forward max_abs_err {fwd_err}, "
            f"statistics {stat_err}, gradients rel_err {bwd_rel} (tolerance "
            f"{tol}), mask bit-identical {mask_same}")
    out_r = {"fwd": {"max_abs_err": fwd_err, "stat_err": stat_err,
                     **_dal_bound("fwd", rows, h, dtype, dh2)},
             "bwd": {"max_abs_err": bwd_abs, "rel_err": bwd_rel,
                     **_dal_bound("bwd", rows, h, dtype, dh2)}}
    if timed:
        hh = ref[1]
        lib_fwd = time_ms(lambda: F.layer_norm(hh, (h,), w, b, DAL_EPS))
        leaves = [a.detach().requires_grad_() for a in (hh, w, b)]
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            F.layer_norm(leaves[0], (h,), leaves[1], leaves[2], DAL_EPS),
            leaves, dy))
        out_r["fwd"].update(
            ms=time_ms(lambda: dal_forward(x, res, w, b, DAL_SEED,
                                           epsilon=DAL_EPS, **kw)),
            plain_ms=time_ms(lambda: dal_forward_plain(
                x, res, w, b, DAL_SEED, epsilon=DAL_EPS, **kw), iters=5),
            library_ms=lib_fwd)
        out_r["bwd"].update(
            ms=time_ms(lambda: dal_backward(*bwd, **kw)),
            plain_ms=time_ms(lambda: dal_backward_plain(*bwd, **kw),
                             iters=5),
            library_ms=lib_fwd_bwd - lib_fwd)
    emit("dal_kernel", case=name, shape=[rows, h], dtype=str(dtype), p=p,
         training=training, dh2=dh2, tol=tol, rtol=rtol,
         mask_bit_identical=mask_same, timed=timed,
         library="torch.nn.functional.layer_norm on h: LayerNorm alone, "
                 "without the dropout or the residual add (bwd: its "
                 "autograd backward)", **out_r)
    return out_r


def phase_dal_kernel() -> dict:
    """The fused encoder's shape ``[8 x 512, 1024]`` (bf16, p 0.1,
    training, no cotangent of h: its main path, timed), the other modes,
    float32 and an odd row count."""
    rows, h = ENC_BATCH * ENC_SEQ, ENC_D
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    for name, n, dtype, p, training, dh2, timed in (
            ("encoder_bf16_p0.1", rows, bf16, ENC_RATE, True, False, True),
            ("bf16_p0.1_dh2", rows, bf16, ENC_RATE, True, True, False),
            ("bf16_p0_dh2", rows, bf16, 0.0, True, True, False),
            ("bf16_eval", rows, bf16, ENC_RATE, False, False, False),
            ("f32_p0.1_dh2", rows, f32, ENC_RATE, True, True, True),
            ("f32_eval", rows, f32, ENC_RATE, False, True, False),
            ("odd_rows_bf16_p0.1", rows - 3, bf16, ENC_RATE, True, True,
             False),
            ("odd_rows_f32_p0.1", 7, f32, ENC_RATE, True, True, False)):
        results[name] = _dal_case(name, n, h, dtype, p, training, dh2, timed)
    return results


# ---------------------------------------------------------------------------
# 6. the serving path: gpt3-350m
# ---------------------------------------------------------------------------
def bench_serving_workload(span: int):
    """``bench.py:bench_serving``'s mixed-length workload: 11 short chats
    and one long document, ``(prompt_len, max_new)`` pairs."""
    r = np.random.RandomState(0)
    return ([(int(t0), int(n)) for t0, n in zip(
        r.randint(span // 16, span // 8, 11),
        r.randint(span // 16, span // 8, 11))]
        + [(span // 2 + span // 4, span // 8)])


def phase_serve(model) -> dict:
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    workload = bench_serving_workload(cfg.max_seq_len)
    eng = ServingEngine(model, page_size=PAGE, max_batch=MAX_BATCH,
                        device=model.device)
    r = np.random.RandomState(1)
    torch.cuda.reset_peak_memory_stats()
    paged_ragged_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(r.randint(0, cfg.vocab_size, (t,)), n)
            for t, n in workload]
    out = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_ragged_attention.launches
    for rid, (_, n) in zip(rids, workload):
        if len(out[rid]) != n:
            raise AssertionError(f"request {rid} returned {len(out[rid])} "
                                 f"tokens, wanted {n}")
    st = eng.stats.to_dict()
    if launches == 0 or launches != cfg.num_layers * st["mixed_steps"]:
        raise AssertionError(f"paged_ragged_attention launched {launches} "
                             f"times in {st['mixed_steps']} steps of "
                             f"{cfg.num_layers} layers")
    fields = {k: st[k] for k in (
        "decode_tokens_per_s", "prefill_tokens_per_s", "p50_token_ms",
        "p99_token_ms", "mixed_steps", "decode_tokens", "prefill_tokens",
        "prefix_hit_tokens", "timed_decode_tokens", "timed_prefill_tokens",
        "decode_s", "prefill_s")}
    emit("serve", model=MODEL, dtype=str(model.dtype), requests=len(rids),
         workload=workload, launches=launches, wall_s=round(wall_s, 3),
         peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
         pool=eng.pool_stats(), **fields)
    return {"launches": launches, **fields}


# ---------------------------------------------------------------------------
# 7. correctness of the serving path on the card
# ---------------------------------------------------------------------------
def phase_check(model) -> None:
    """Two requests through an engine on a float32 copy of the weights
    against greedy decoding that recomputes plain ``GPT.forward`` at every
    step.  Tokens must agree up to the first step where the reference's
    top-2 logit gap is below 1e-3 (there a 1-ulp difference may flip the
    argmax)."""
    from paddle_ray_tpu_torch.serving import ServingEngine
    m32 = copy.deepcopy(model).float()
    r = np.random.RandomState(2)
    prompts = [r.randint(0, m32.cfg.vocab_size, (n,)) for n in (40, 100)]
    new = 16
    eng = ServingEngine(m32, page_size=PAGE, max_batch=MAX_BATCH,
                        device=m32.device)
    rids = [eng.submit(p, new) for p in prompts]
    out = eng.run()
    report = []
    for rid, p in zip(rids, prompts):
        ids = torch.tensor(p, dtype=torch.long, device=m32.device)[None]
        ref, tie_at = [], None
        with torch.no_grad():
            for step in range(new):
                logits = m32(ids)[0, -1].float()
                top2 = torch.topk(logits, 2).values
                if tie_at is None and float(top2[0] - top2[1]) < 1e-3:
                    tie_at = step
                tok = int(torch.argmax(logits))
                ref.append(tok)
                ids = torch.cat([ids, ids.new_tensor([[tok]])], dim=1)
        upto = new if tie_at is None else tie_at
        got = [int(t) for t in out[rid]]
        if len(got) != new or got[:upto] != ref[:upto]:
            raise AssertionError(f"request {rid}: engine {got} vs plain "
                                 f"GPT.forward {ref} (near tie at {tie_at})")
        report.append({"rid": rid, "prompt_tokens": len(p),
                       "equal_tokens": upto, "near_tie_at": tie_at})
    emit("check", dtype="float32", requests=report)
    del eng, m32


# ---------------------------------------------------------------------------
# 8. the serving path with the int8 KV pool and sampled requests
# ---------------------------------------------------------------------------
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _serve_requests(eng, prompts, news, sampling):
    rids = [eng.submit(p, n, **kw)
            for p, n, kw in zip(prompts, news, sampling)]
    out = eng.run()
    return [out[r] for r in rids]


def phase_serve_int8(model) -> dict:
    """The serving workload over an int8 KV pool, every other request
    sampled with its own seed."""
    from paddle_ray_tpu_torch.ops.paged_attention import (
        paged_ragged_attention)
    from paddle_ray_tpu_torch.serving import ServingEngine
    cfg = model.cfg
    workload = bench_serving_workload(cfg.max_seq_len)
    r = np.random.RandomState(1)
    prompts = [r.randint(0, cfg.vocab_size, (t,)) for t, _ in workload]
    news = [n for _, n in workload]
    sampling = [dict(SAMPLED, seed=1000 + i) if i % 2 else {}
                for i in range(len(workload))]
    kw = dict(page_size=PAGE, max_batch=MAX_BATCH, kv_cache_dtype="int8",
              device=model.device)
    eng = ServingEngine(model, **kw)
    torch.cuda.reset_peak_memory_stats()
    paged_ragged_attention.launches = paged_ragged_attention.launches_q8 = 0
    t0 = time.perf_counter()
    out = _serve_requests(eng, prompts, news, sampling)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_ragged_attention.launches_q8
    st = eng.stats.to_dict()
    for i, (toks, n) in enumerate(zip(out, news)):
        if len(toks) != n:
            raise AssertionError(f"int8 request {i} returned {len(toks)} "
                                 f"tokens, wanted {n}")
    if (launches == 0 or launches != cfg.num_layers * st["mixed_steps"]
            or paged_ragged_attention.launches != 0):
        raise AssertionError(
            f"paged int8 kernel launched {launches} times (bf16 kernel "
            f"{paged_ragged_attention.launches}) in {st['mixed_steps']} "
            f"steps of {cfg.num_layers} layers")
    # streams depend only on seed and position: four sampled requests
    # served by a fresh engine, and in reverse order (other slots) by
    # another, draw the same tokens.  Their prompts are 8 tokens, so every
    # step multiplies at most 64 rows: cuBLAS's bf16 GEMMs tile larger row
    # counts so that a row's sums depend on its place in the batch, and
    # then a sampled token at a near tie may change with the slot.
    r = np.random.RandomState(3)
    same_len = [r.randint(0, cfg.vocab_size, (8,)) for _ in range(4)]
    four = [dict(SAMPLED, seed=2000 + i) for i in range(4)]
    fwd = _serve_requests(ServingEngine(model, **kw), same_len, [64] * 4,
                          four)
    rev = _serve_requests(ServingEngine(model, **kw), same_len[::-1],
                          [64] * 4, four[::-1])[::-1]
    for i, (a, b) in enumerate(zip(fwd, rev)):
        if not np.array_equal(a, b):
            first = int(np.argmax(a != b))
            raise AssertionError(
                f"sampled request {i} served in reverse order drew other "
                f"tokens from position {first}: {b[:first + 4]} vs "
                f"{a[:first + 4]}")
    # the workload's first four sampled requests alone, in reverse order:
    # other step shapes than the 12-request run; the share of their tokens
    # equal to that run's is reported, not held
    again_idx = [i for i, kw_i in enumerate(sampling) if kw_i][:4][::-1]
    again = _serve_requests(ServingEngine(model, **kw),
                            [prompts[i] for i in again_idx],
                            [news[i] for i in again_idx],
                            [sampling[i] for i in again_idx])
    equal_share = float(np.mean(np.concatenate(
        [toks == out[i] for i, toks in zip(again_idx, again)])))
    first_diff = [int(np.argmax(toks != out[i])) if (toks != out[i]).any()
                  else None for i, toks in zip(again_idx, again)]
    greedy = [i for i, kw_i in enumerate(sampling) if not kw_i]
    fields = {k: st[k] for k in (
        "decode_tokens_per_s", "prefill_tokens_per_s", "p50_token_ms",
        "p99_token_ms", "mixed_steps", "decode_tokens", "prefill_tokens",
        "prefix_hit_tokens", "timed_decode_tokens", "timed_prefill_tokens",
        "decode_s", "prefill_s")}
    emit("serve_int8", model=MODEL, dtype=str(model.dtype),
         kv_cache_dtype="int8", requests=len(out),
         sampled=[i for i in range(len(out)) if sampling[i]],
         sampling=SAMPLED, greedy=greedy, launches_q8=launches,
         reverse_order_equal=True, workload_resubmitted=again_idx,
         workload_resubmitted_equal_share=equal_share,
         workload_resubmitted_first_diff=first_diff, wall_s=round(wall_s, 3),
         peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 3),
         pool=eng.pool_stats(), **fields)
    return {"launches": launches, **fields}


# ---------------------------------------------------------------------------
# 9. generate(): bench.py's two generation rows
# ---------------------------------------------------------------------------
def _decode_counters():
    from paddle_ray_tpu_torch.ops.decode_attention import (
        fused_decode_attention)
    from paddle_ray_tpu_torch.ops.decode_matmul import int8_stream_matmul
    return {
        "fused_decode_attention": (fused_decode_attention, "launches"),
        "fused_decode_attention_q8": (fused_decode_attention, "launches_q8"),
        "int8_stream_matmul": (int8_stream_matmul, "launches"),
    }


def _reset(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters) -> dict:
    return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}


def phase_generate(model) -> dict:
    """(a) bf16 ``generate()``, (b) ``quantize_for_decode`` with the int8
    KV cache: batch 8, prompt 128, 256 new tokens, one warm-up and two
    timed calls; every call must launch the kernels the path runs the
    expected number of times.  Then 16 new tokens of each under
    ``torch.profiler``, beside the same call unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_ray_tpu_torch.models import generate, quantize_for_decode
    cfg = model.cfg
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))).to("cuda")
    steps = GEN_NEW - 1                   # decode steps after the prefill
    n_layers = cfg.num_layers
    configs = {
        "bf16": (model, {}, {"fused_decode_attention": n_layers * steps}),
        "int8": (quantize_for_decode(model), {"kv_cache_dtype": "int8"},
                 {"fused_decode_attention_q8": n_layers * steps,
                  # the prefill's LM head row, then 4 linears per layer
                  # and the head at every decode step
                  "int8_stream_matmul": 1 + steps * (4 * n_layers + 1)}),
    }
    counters = _decode_counters()
    results, outs = {}, {}
    for name, (m, kw, expect) in configs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        generate(m, ids, GEN_NEW, **kw)                      # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(2):
            _reset(counters)
            t0 = time.perf_counter()
            out = generate(m, ids, GEN_NEW, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = _read(counters)
            want = {n: expect.get(n, 0) for n in counters}
            if launches != want:
                raise AssertionError(f"generate {name}: launches {launches}"
                                     f", want {want}")
        if (out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW)
                or not torch.equal(out[:, :GEN_PROMPT], ids)
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
            raise AssertionError(f"generate {name}: bad output {out.shape}")
        outs[name] = out[:, GEN_PROMPT:]
        call_s = float(np.mean(times))
        r = {"tokens_per_s": GEN_BATCH * GEN_NEW / call_s,
             "ms_per_token": 1e3 * call_s / GEN_NEW,
             "call_s": times,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
             "launches_per_call": launches}

        # where the time goes: a 16-token call, unprofiled then profiled
        short = 16
        generate(m, ids, short, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(m, ids, short, **kw)
        torch.cuda.synchronize()
        short_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            generate(m, ids, short, **kw)
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        device_ms = sum(t for _, t, _ in rows) / 1e3
        top = sorted(rows, key=lambda x: -x[1])[:10]
        r["profile"] = {
            "new_tokens": short, "call_ms_unprofiled": short_ms,
            "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / short_ms,
            "kernels_launched": sum(c for _, _, c in rows),
            "top_kernels": [{"name": k[:80], "ms": t / 1e3, "calls": c}
                            for k, t, c in top]}
        results[name] = r
        emit("generate", model=MODEL, config=name, batch=GEN_BATCH,
             prompt=GEN_PROMPT, new_tokens=GEN_NEW,
             weights="bf16" if name == "bf16" else "int8 (weight-only)",
             kv_cache=kw.get("kv_cache_dtype", "model"), **r)
    results["bf16_int8_equal_share"] = float(
        (outs["bf16"] == outs["int8"]).float().mean())
    emit("generate_agreement",
         share_of_new_tokens_equal=results["bf16_int8_equal_share"])
    del configs
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# 10. correctness of the decode path on the card
# ---------------------------------------------------------------------------
CHECK_TIE = 1e-3


def _first_gap(model, seq, t0, j) -> float:
    """The top-2 gap of plain ``GPT.forward``'s logits for new token ``j``
    of ``seq`` (the smallest over the batch rows)."""
    with torch.no_grad():
        logits = model(seq[:, :t0 + j])[:, -1].float()
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _same_tokens(name, model, got, want, t0) -> dict:
    """Greedy tokens of two paths must be equal, except from a step where
    the reference's top-2 logit gap is below ``CHECK_TIE`` (there float32
    sums taken in another order may flip the argmax)."""
    diff = torch.nonzero((got != want).any(dim=0)).flatten()
    if diff.numel() == 0:
        return {"equal_tokens": int(got.shape[1] - t0), "near_tie_at": None}
    j = int(diff[0]) - t0
    gap = _first_gap(model, want, t0, j)
    if j < 0 or gap >= CHECK_TIE:
        raise AssertionError(f"generate_check {name}: tokens differ at new "
                             f"token {j} where the top-2 gap is {gap}")
    return {"equal_tokens": j, "near_tie_at": j, "gap": gap}


def phase_generate_check() -> None:
    """A 4-layer float32 model of gpt3-350m's width: the kernels' greedy
    tokens against the plain chain (``fused_attention=False``) for the
    dense cache in the model's dtype and in int8, and the paged layout
    against the dense one; then the threefry bits of 4,096 (seed,
    position) keys on the card against the CPU."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.models import build_gpt, generate
    from paddle_ray_tpu_torch.models.generation import fold_sample_keys
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    model = build_gpt(MODEL, device="cuda", dtype=torch.float32,
                      num_layers=4, max_seq_len=512, generator=g)
    b, t0, new = GEN_BATCH, 64, 32
    ids = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, model.cfg.vocab_size, (b, t0))).to("cuda")
    report = {}
    for kv in ("model", "int8"):
        kernel = generate(model, ids, new, kv_cache_dtype=kv)
        plain = generate(model, ids, new, kv_cache_dtype=kv,
                         fused_attention=False)
        paged = generate(model, ids, new, kv_cache_dtype=kv,
                         kv_layout="paged", page_size=PAGE)
        report[f"fused_vs_plain_{kv}"] = _same_tokens(
            f"fused vs plain ({kv} KV)", model, kernel, plain, t0)
        report[f"paged_vs_dense_{kv}"] = _same_tokens(
            f"paged vs dense ({kv} KV)", model, paged, kernel, t0)
    r = np.random.RandomState(SEED + 2)
    seeds = np.concatenate([np.asarray([0, 2 ** 31 + 5, 2 ** 32 - 1],
                                       np.uint64),
                            r.randint(0, 2 ** 32, 4093, dtype=np.uint64)])
    positions = r.randint(0, 4096, 4096)
    bits = {}
    for dev in ("cuda", "cpu"):
        keys = fold_sample_keys(torch.from_numpy(seeds.astype(np.int64)).to(
            dev), torch.from_numpy(positions).to(dev))
        bits[dev] = prng.random_bits(keys, (16,)).cpu()
    if not torch.equal(bits["cuda"], bits["cpu"]):
        raise AssertionError("threefry bits differ between the card and the "
                             "CPU")
    emit("generate_check", dtype="float32", layers=4, batch=b, prompt=t0,
         new_tokens=new, tie=CHECK_TIE, threefry_keys=len(seeds),
         threefry_bits_equal=True, **report)
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 11. the training path: gpt3-350m
# ---------------------------------------------------------------------------
def _flash_counters():
    from paddle_ray_tpu_torch.ops.flash_attention import (
        flash_backward_dkv, flash_backward_dq, flash_forward)
    return dict(zip(FLASH_KERNELS, (flash_forward, flash_backward_dq,
                                    flash_backward_dkv)))


def phase_train() -> dict:
    from torch.profiler import ProfilerActivity, profile
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    # bench.py builds the model with max_seq_len = seq
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      attn_impl="flash", remat=False, max_seq_len=TRAIN_SEQ,
                      generator=g)
    cfg = model.cfg
    ts = build_train_step(model, AdamW(TRAIN_LR), gpt_loss_fn)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    batch = (ids, ids)
    counters = _flash_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses = [ts.step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [ts.step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: "
                             f"{losses}")
    for n, count in launches.items():
        if count != cfg.num_layers * steps:
            raise AssertionError(f"{n} launched {count} times in {steps} "
                                 f"steps of {cfg.num_layers} layers")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TIMED_STEPS / dt
    # bench.py's count: 6 N + 12 L H S FLOP per token, against the bf16 peak
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ)
    step_ms = 1e3 * dt / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    emit("train", model=MODEL, dtype="bfloat16", attn_impl="flash",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, optimizer=f"AdamW({TRAIN_LR})",
         steps=steps, timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=losses, **out)

    # one more step under the profiler: where a step's device time goes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts.step(batch)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    device_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:8]
    emit("train_profile", steps=1, step_ms_unprofiled=step_ms,
         device_ms=device_ms, device_idle_share=1.0 - device_ms / step_ms,
         kernels_launched=sum(c for _, _, c in rows),
         flash_ms=sum(t for k, t, _ in rows if "flash_" in k) / 1e3,
         top_kernels=[{"name": k[:90], "ms": t / 1e3, "calls": c}
                      for k, t, c in top],
         annotated_spans=[{"name": k, "ms": t / 1e3}
                          for k, t in annotation_spans(prof)])
    del ts, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 12. correctness of the training path on the card
# ---------------------------------------------------------------------------
def phase_train_check() -> None:
    """A 4-layer float32 model of gpt3-350m's width, built twice from one
    set of weights: flash kernels against plain dense attention."""
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    b, s = 2, 512
    models = {}
    for impl in ("flash", "dense"):
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 1)
        models[impl] = build_gpt(MODEL, device="cuda", dtype=torch.float32,
                                 num_layers=4, max_seq_len=s, remat=False,
                                 attn_impl=impl, generator=g)
    ids = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, models["flash"].cfg.vocab_size, (b, s))).to("cuda")
    grads = {}
    for impl, m in models.items():
        gpt_loss_fn(m, (ids, ids)).backward()
        grads[impl] = {n: p.grad.clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    grad_err = {n: _rel_err(grads["flash"][n], want)
                for n, want in grads["dense"].items()}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > 1e-3:
        raise AssertionError(f"train_check: grad of {worst} off by "
                             f"{grad_err[worst]} (max|err|/max|ref|)")
    losses = {}
    for impl, m in models.items():
        ts = build_train_step(m, AdamW(TRAIN_LR), gpt_loss_fn)
        losses[impl] = [float(ts.step((ids, ids))) for _ in range(3)]
    if not np.allclose(losses["flash"], losses["dense"], rtol=1e-3, atol=0):
        raise AssertionError(f"train_check: losses {losses}")
    emit("train_check", dtype="float32", layers=4, batch=b, seq=s,
         max_grad_rel_err=grad_err[worst], worst_param=worst,
         losses=losses, grad_tol=1e-3, loss_rtol=1e-3)
    del models, grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 14. the UNet training path: bench.py's SD-UNet
# ---------------------------------------------------------------------------
def _gn_counters():
    from paddle_ray_tpu_torch.ops.groupnorm import (fused_group_norm_bwd,
                                                    fused_group_norm_fwd)
    return dict(zip(GN_KERNELS, (fused_group_norm_fwd, fused_group_norm_bwd)))


def phase_unet_train() -> dict:
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from paddle_ray_tpu_torch.models import (UNetConfig, build_unet,
                                             unet_loss_fn)
    from paddle_ray_tpu_torch.ops.groupnorm import fused_group_norm
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_unet(UNetConfig(**UNET_CFG), dtype=torch.bfloat16,
                       device="cuda", generator=g)
    b, img = UNET_BATCH, UNET_IMG
    x = torch.randn(b, img, img, 4, generator=g, device="cuda").bfloat16()
    t = torch.randint(0, 1000, (b,), generator=g, device="cuda")
    eps = torch.randn(b, img, img, 4, generator=g, device="cuda").bfloat16()
    batch = (x, t, eps)
    # the forward's FLOPs (convolutions and matmuls, as counted by
    # PyTorch), x 3 for a training step: bench.py's convention
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, t)
    fwd_flops = fc.get_total_flops()
    ts = build_train_step(model, AdamW(UNET_LR), unet_loss_fn)
    counters = _gn_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    fused_group_norm.copies = 0
    losses = [ts.step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [ts.step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    copies = fused_group_norm.copies
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"unet losses not finite and falling: {losses}")
    per_step = len(unet_gn_calls())
    for n, count in launches.items():
        if count != per_step * steps:
            raise AssertionError(f"{n} launched {count} times in {steps} "
                                 f"steps, want {per_step} a step")
    images_per_s = b * TIMED_STEPS / dt
    step_ms = 1e3 * dt / TIMED_STEPS
    out = {"images_per_s": images_per_s, "step_ms": step_ms,
           "mfu": images_per_s * 3 * fwd_flops / b
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "launches_per_step": per_step,
           "group_norm_input_copies": copies}
    emit("unet_train", config=UNET_CFG, dtype="bfloat16", batch=b, img=img,
         optimizer=f"AdamW({UNET_LR})", steps=steps, timed_steps=TIMED_STEPS,
         n_params=sum(p.numel() for p in model.parameters()),
         fwd_flops_per_image=fwd_flops / b, losses=losses, **out)

    # one more step under the profiler: where a step's device time goes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts.step(batch)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    device_ms = sum(t_ for _, t_, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:12]

    def share(*keys):
        return sum(t_ for k, t_, _ in rows if any(q in k for q in keys)) / 1e3
    # device ms by kind, by kernel name (in this order): cuDNN's convolution
    # kernels are named fprop / dgrad / wgrad, cuBLAS's GEMMs gemm or nvjet
    kinds = {"group_norm": ("gn_fwd_kernel", "gn_bwd"),
             "convolution": ("fprop", "dgrad", "wgrad", "convolve", "cudnn"),
             "matmul": ("gemm", "nvjet"), "softmax": ("softmax",)}
    by_kind, seen = {}, set()
    for kind, keys in kinds.items():
        names = {k for k, _, _ in rows if k not in seen
                 and any(q in k.lower() for q in keys)}
        seen |= names
        by_kind[kind] = sum(t_ for k, t_, _ in rows if k in names) / 1e3
    by_kind["other"] = device_ms - sum(by_kind.values())
    emit("unet_profile", steps=1, step_ms_unprofiled=step_ms,
         device_ms=device_ms, device_idle_share=1.0 - device_ms / step_ms,
         kernels_launched=sum(c for _, _, c in rows),
         device_ms_by_kind=by_kind,
         group_norm_ms={"fwd": share("gn_fwd_kernel"),
                        "bwd": share("gn_bwd_kernel", "gn_bwd_reduce")},
         top_kernels=[{"name": k[:90], "ms": t_ / 1e3, "calls": c}
                      for k, t_, c in top],
         annotated_spans=[{"name": k, "ms": t_ / 1e3}
                          for k, t_ in annotation_spans(prof)])
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 15. correctness of the UNet training path on the card
# ---------------------------------------------------------------------------
UNET_CHECK_CFG = dict(UNET_CFG, channel_mults=(1, 2), blocks_per_level=1,
                      attn_levels=(1,))


def phase_unet_check() -> None:
    """A shallow float32 UNet of SD width on the card (kernels) and as a
    copy on the CPU (plain versions), TF32 off for both convolutions and
    matmuls."""
    from paddle_ray_tpu_torch.models import (UNetConfig, build_unet,
                                             unet_loss_fn)
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    models = {"cuda": build_unet(UNetConfig(**UNET_CHECK_CFG),
                                 dtype=torch.float32, device="cuda",
                                 generator=g)}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    r = np.random.RandomState(SEED + 3)
    b, img = 2, 32
    arrays = (r.randn(b, img, img, 4).astype(np.float32),
              np.asarray([17, 901]),
              r.randn(b, img, img, 4).astype(np.float32))
    batches = {dev: tuple(torch.from_numpy(a).to(dev) for a in arrays)
               for dev in models}
    counters = _gn_counters()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        ys = {dev: m(*batches[dev][:2]) for dev, m in models.items()}
    fwd_err = _rel_err(ys["cuda"].cpu(), ys["cpu"])
    if not fwd_err <= 1e-4:
        raise AssertionError(f"unet_check: forward off by {fwd_err} "
                             f"(max|err|/max|ref|)")
    grads = {}
    for dev, m in models.items():
        unet_loss_fn(m, batches[dev]).backward()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in
                      m.named_parameters()}
        m.zero_grad(set_to_none=True)
    launches = {n: c.launches for n, c in counters.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"unet_check: GroupNorm kernels not launched "
                             f"on the card: {launches}")
    grad_err = {n: _rel_err(grads["cuda"][n], want)
                for n, want in grads["cpu"].items()}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > 1e-3:
        raise AssertionError(f"unet_check: grad of {worst} off by "
                             f"{grad_err[worst]} (max|err|/max|ref|)")
    losses = {}
    for dev, m in models.items():
        ts = build_train_step(m, AdamW(UNET_LR), unet_loss_fn)
        losses[dev] = [float(ts.step(batches[dev])) for _ in range(3)]
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-3, atol=0):
        raise AssertionError(f"unet_check: losses {losses}")
    emit("unet_check", config=UNET_CHECK_CFG, dtype="float32", batch=b,
         img=img, tf32=False, forward_rel_err=fwd_err,
         max_grad_rel_err=grad_err[worst], worst_param=worst,
         losses=losses, launches=launches, fwd_tol=1e-4, grad_tol=1e-3,
         loss_rtol=1e-3)
    del models, grads, ys
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. the BERT pretraining path: bench.py's BERT-large
# ---------------------------------------------------------------------------
def _profile_step(step, label, step_ms, groups) -> None:
    """One more ``step()`` under ``torch.profiler``: device ms, idle
    share, launches, the top kernels and the device ms of each named
    group of kernel-name keys."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    device_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:10]
    emit(label, steps=1, step_ms_unprofiled=step_ms, device_ms=device_ms,
         device_idle_share=1.0 - device_ms / step_ms,
         kernels_launched=sum(c for _, _, c in rows),
         group_ms={name: sum(t for k, t, _ in rows
                             if any(q in k for q in keys)) / 1e3
                   for name, keys in groups.items()},
         top_kernels=[{"name": k[:90], "ms": t / 1e3, "calls": c}
                      for k, t, c in top],
         annotated_spans=[{"name": k, "ms": t / 1e3}
                          for k, t in annotation_spans(prof)])


def _timed_train(ts, step, counters, per_step, what) -> dict:
    """2 warm-up and 10 timed ``step()`` calls with the kernel counters
    set to 0 first: losses finite and falling, each counter at
    ``per_step`` a step.  Returns the losses, seconds and launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses = [step(i) for i in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(WARMUP_STEPS + i) for i in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what} losses not finite and falling: "
                             f"{losses}")
    for n, count in launches.items():
        if count != per_step[n] * steps:
            raise AssertionError(f"{what}: {n} launched {count} times in "
                                 f"{steps} steps, want {per_step[n]} a step")
    return {"losses": losses, "seconds": dt, "launches": launches,
            "steps": steps,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}


def phase_bert_train() -> dict:
    from paddle_ray_tpu_torch.models import (BertForPretraining, bert_config,
                                             bert_pretrain_loss_fn)
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    cfg = bert_config(BERT_MODEL, max_seq_len=BERT_SEQ, dtype="bfloat16",
                      attn_impl="flash")
    model = BertForPretraining(cfg, device="cuda", generator=g)
    ts = build_train_step(model, AdamW(BERT_LR), bert_pretrain_loss_fn)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))).to("cuda")
    batch = {"ids": ids, "mlm_labels": ids,
             "nsp_labels": torch.zeros(BERT_BATCH, dtype=torch.long,
                                       device="cuda")}
    counters = _flash_counters()
    run = _timed_train(ts, lambda i: ts.step(batch), counters,
                       {n: cfg.num_layers for n in counters}, "bert_train")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = BERT_BATCH * BERT_SEQ * TIMED_STEPS / run["seconds"]
    # bench.py's count: 6 N + 12 L H S FLOP per token, against the bf16 peak
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * BERT_SEQ)
    step_ms = 1e3 * run["seconds"] / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "peak_memory_gb": run["peak_memory_gb"],
           "launches": run["launches"]}
    emit("bert_train", model=BERT_MODEL, dtype="bfloat16",
         attn_impl="flash", batch=BERT_BATCH, seq=BERT_SEQ,
         optimizer=f"AdamW({BERT_LR})", steps=run["steps"],
         timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=run["losses"], **out)
    _profile_step(lambda: ts.step(batch), "bert_profile", step_ms,
                  {"flash": ("flash_",), "matmul": ("gemm", "nvjet")})
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 18. correctness of the BERT path on the card
# ---------------------------------------------------------------------------
def phase_bert_check() -> None:
    """BERT-large width in float32, 4 layers, padded (segment ids on the
    flash path), on the card (kernels) and as a copy on the CPU (plain
    versions), TF32 off."""
    from paddle_ray_tpu_torch.models import (BertForPretraining, bert_config,
                                             bert_pretrain_loss_fn)
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = 2, BERT_SEQ
    cfg = bert_config(BERT_MODEL, max_seq_len=s, num_layers=4,
                      attn_impl="flash")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    models = {"cuda": BertForPretraining(cfg, device="cuda", generator=g)}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    r = np.random.RandomState(SEED + 4)
    lengths = (512, 333)
    arrays = {"ids": r.randint(0, cfg.vocab_size, (b, s)),
              "token_type_ids": (np.arange(s)[None, :] >= 200).repeat(b, 0),
              "attention_mask": (np.arange(s)[None, :]
                                 < np.asarray(lengths)[:, None]),
              "mlm_labels": np.where(r.rand(b, s) < 0.15,
                                     r.randint(0, cfg.vocab_size, (b, s)),
                                     -100),
              "nsp_labels": np.asarray([0, 1])}
    batches = {dev: {k: torch.from_numpy(np.asarray(a)).long().to(dev)
                     for k, a in arrays.items()} for dev in models}
    counters = _flash_counters()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        logits = {dev: m(batches[dev]["ids"], batches[dev]["token_type_ids"],
                         batches[dev]["attention_mask"])[0]
                  for dev, m in models.items()}
    fwd_err = _rel_err(logits["cuda"].cpu(), logits["cpu"])
    if not fwd_err <= 1e-4:
        raise AssertionError(f"bert_check: MLM logits off by {fwd_err} "
                             f"(max|err|/max|ref|)")
    del logits
    grads = {}
    for dev, m in models.items():
        bert_pretrain_loss_fn(m, batches[dev]).backward()
        grads[dev] = {n: p.grad.detach().cpu()
                      for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    launches = {n: c.launches for n, c in counters.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"bert_check: flash kernels not launched on "
                             f"the card: {launches}")
    grad_err = {n: _rel_err(grads["cuda"][n], want)
                for n, want in grads["cpu"].items()}
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > 1e-3:
        raise AssertionError(f"bert_check: grad of {worst} off by "
                             f"{grad_err[worst]} (max|err|/max|ref|)")
    losses = {}
    for dev, m in models.items():
        ts = build_train_step(m, AdamW(BERT_LR), bert_pretrain_loss_fn)
        losses[dev] = [float(ts.step(batches[dev])) for _ in range(3)]
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-3, atol=0):
        raise AssertionError(f"bert_check: losses {losses}")
    emit("bert_check", dtype="float32", layers=4, batch=b, seq=s,
         lengths=list(lengths), tf32=False, forward_rel_err=fwd_err,
         max_grad_rel_err=grad_err[worst], worst_param=worst,
         losses=losses, launches=launches, fwd_tol=1e-4, grad_tol=1e-3,
         loss_rtol=1e-3)
    del models, grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 19. the fused encoder: 24 FusedTransformerEncoderLayer of BERT-large width
# ---------------------------------------------------------------------------
class _EncoderStack(torch.nn.Module):
    """``FusedTransformerEncoderLayer``s in a row, each under its own key
    (``fold_in(rng, layer)``)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, src, src_mask, rng=None):
        from paddle_ray_tpu_torch.core import prng
        for i, layer in enumerate(self.layers):
            src = layer(src, src_mask,
                        rng=None if rng is None else prng.fold_in(rng, i))
        return src


def _dal_counters():
    from paddle_ray_tpu_torch.ops.fused import dal_backward, dal_forward
    return dict(zip(DAL_KERNELS, (dal_forward, dal_backward)))


def _encoder_stack(n_layers, dtype, g, device="cuda") -> _EncoderStack:
    """The fused encoder at BERT-large width (post-LN, dropout 0.1 at the
    residuals only), weights drawn from ``g``."""
    from paddle_ray_tpu_torch.incubate import FusedTransformerEncoderLayer
    return _EncoderStack([FusedTransformerEncoderLayer(
        ENC_D, ENC_HEADS, ENC_FFN, dropout_rate=ENC_RATE, activation="gelu",
        attn_dropout_rate=0.0, act_dropout_rate=0.0, normalize_before=False,
        dtype=dtype, device=device, generator=g)
        for _ in range(n_layers)])


def _padding_mask(lengths, s, device="cuda") -> torch.Tensor:
    """``[B, S]`` boolean: True on each row's first ``lengths[b]`` keys."""
    return (torch.arange(s, device=device)[None, :]
            < torch.tensor(lengths, device=device)[:, None])


def phase_encoder_train() -> dict:
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = _encoder_stack(ENC_LAYERS, "bfloat16", g)
    b, s = ENC_BATCH, ENC_SEQ
    src = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    target = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    src_mask = _padding_mask(ENC_LENGTHS, s)[:, None, None, :]

    def loss_fn(m, batch, rng):
        x, mask, y = batch
        return ((m(x, mask, rng).float() - y.float()) ** 2).mean()
    ts = build_train_step(model, AdamW(ENC_LR), loss_fn)
    batch = (src, src_mask, target)
    root = prng.PRNGKey(0)
    counters = {**_dal_counters(), **_flash_counters()}
    per_step = {**{n: 2 * ENC_LAYERS for n in DAL_KERNELS},
                **{n: ENC_LAYERS for n in FLASH_KERNELS}}
    run = _timed_train(ts, lambda i: ts.step(batch, prng.fold_in(root, i)),
                       counters, per_step, "encoder_train")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = b * s * TIMED_STEPS / run["seconds"]
    flops_per_token = 6 * n_params + 12 * ENC_LAYERS * ENC_D * s
    step_ms = 1e3 * run["seconds"] / TIMED_STEPS
    out = {"tokens_per_s": tokens_per_s, "step_ms": step_ms,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_OPS_PER_S[torch.bfloat16],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "peak_memory_gb": run["peak_memory_gb"],
           "launches": run["launches"]}
    emit("encoder_train", layers=ENC_LAYERS, d_model=ENC_D, heads=ENC_HEADS,
         ffn=ENC_FFN, dropout_rate=ENC_RATE, dtype="bfloat16", batch=b,
         seq=s, lengths=list(ENC_LENGTHS), optimizer=f"AdamW({ENC_LR})",
         steps=run["steps"], timed_steps=TIMED_STEPS, n_params=n_params,
         flops_per_token=flops_per_token, losses=run["losses"], **out)
    _profile_step(lambda: ts.step(batch, prng.fold_in(root, 99)),
                  "encoder_profile", step_ms,
                  {"dropout_add_layernorm": ("dal_fwd", "dal_bwd"),
                   "flash": ("flash_",), "matmul": ("gemm", "nvjet")})
    del ts, model, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 20. the int8 matmul kernel against its plain version
# ---------------------------------------------------------------------------
def _int8_bound(m, k, n, out_dtype) -> dict:
    """The least time: the int8 operands and the float32 scales read once,
    the output written once, over the HBM rate, against 2 M N K
    operations over the int8 tensor-core peak; the larger of the two."""
    es = torch.tensor([], dtype=out_dtype).element_size()
    n_bytes = m * k + k * n + 4 * m + 4 * n + m * n * es
    ops = 2 * m * n * k
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.int8]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": ops}


def _int8_case(name, m, k, n, out_dtype, timed, linear_form=False) -> dict:
    """One case: the kernel (through ``int8_mm``, which takes any shape)
    against ``int8_matmul_plain`` on the same random int8 values and
    positive scales, ``torch.equal``; with ``timed`` the kernel, the plain
    version and the library yardstick ``torch._int_mm`` (its B operand
    made column-major first, outside the timing) followed by the two
    scale products, and ``torch._int_mm``'s int32 product alone.
    ``linear_form``: ``x_scale = 1`` and ``w_scale = s_x * s_w``, as
    ``QuantizedLinear`` calls it."""
    from paddle_ray_tpu_torch.ops.fused import int8_matmul_plain, int8_mm
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + m + k + n)
    xq = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    xs = torch.rand(m, generator=g, device="cuda") * 1e-2 + 1e-3
    ws = torch.rand(n, generator=g, device="cuda") * 1e-2 + 1e-3
    if linear_form:
        xs = torch.ones(m, device="cuda")
        ws = ws * 0.0371
    got = int8_mm(xq, wq, xs, ws, out_dtype)
    torch.cuda.synchronize()
    want = int8_matmul_plain(xq, wq, xs, ws, out_dtype)
    err = float((got.float() - want.float()).abs().max())
    if not (torch.equal(got, want) and torch.isfinite(got).all()):
        raise AssertionError(f"int8_matmul {name}: kernel differs from the "
                             f"plain version (max_abs_err {err})")
    r = {"max_abs_err": err, "equal": True,
         **_int8_bound(m, k, n, out_dtype)}
    if timed:
        w_cm = wq.t().contiguous().t()      # column-major, as _int_mm wants

        def library():
            return (torch._int_mm(xq, w_cm).float() * xs[:, None]
                    * ws[None, :]).to(out_dtype)
        r.update(ms=time_ms(lambda: int8_mm(xq, wq, xs, ws, out_dtype)),
                 plain_ms=time_ms(lambda: int8_matmul_plain(
                     xq, wq, xs, ws, out_dtype), iters=5),
                 library_ms=time_ms(library),
                 int_mm_ms=time_ms(lambda: torch._int_mm(xq, w_cm)))
    emit("int8_mm_kernel", case=name, shape=[m, k, n],
         out_dtype=str(out_dtype), linear_form=linear_form, timed=timed,
         library="torch._int_mm(xq, wq column-major) then * x_scale[:, "
                 "None] * w_scale[None, :] in float32", **r)
    return r


def phase_int8_mm_kernel() -> dict:
    """The fused encoder's four linears at M = 8 x 512 and gpt3-350m's
    fc1 at its training batch (timed), bfloat16 output, the
    ``QuantizedLinear`` form, and ragged M, N and K (the byte-wise loads:
    K not a multiple of 16; the vector loads with a half-empty last K
    slab)."""
    m = ENC_BATCH * ENC_SEQ
    f32, bf16 = torch.float32, torch.bfloat16
    results = {}
    for name, mm, k, n, dt, timed, form in (
            *((lin, m, k, n, f32, True, False) for lin, k, n in ENC_LINEARS),
            ("fc1_8192", 8192, 1024, 4096, f32, True, False),
            ("linear1_bf16", m, ENC_D, ENC_FFN, bf16, False, False),
            ("linear1_quantized_linear", m, ENC_D, ENC_FFN, f32, False,
             True),
            ("ragged_m4093_n97_k1000", m - 3, 1000, 97, f32, False, False),
            ("ragged_m4093_n97_k1000_bf16", m - 3, 1000, 97, bf16, False,
             False),
            ("ragged_m4093_n1000_k1040", m - 3, 1040, 1000, f32, False,
             False),
            ("tiny_5x37x3", 5, 37, 3, bf16, False, False)):
        results[name] = _int8_case(name, mm, k, n, dt, timed, form)
    return results


def _int8_forward_sum(cases, layers) -> dict:
    """One forward's ``layers`` x four int8 products: times and bounds
    summed over the encoder cases (each launch is bounded on its own, so
    the forward's bound is the sum of theirs), and what sets the larger
    share of that sum."""
    out = {key: layers * sum(cases[lin][key] for lin, _, _ in ENC_LINEARS)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {k: sum(cases[lin]["bound_ms"] for lin, _, _ in ENC_LINEARS
                 if cases[lin]["bound_by"] == k)
          for k in ("bytes", "operations")}
    out["bound_by"] = max(by, key=by.get)
    return out


# ---------------------------------------------------------------------------
# 21. dynamic-PTQ int8 inference of the fused encoder
# ---------------------------------------------------------------------------
def _forward_counters():
    from paddle_ray_tpu_torch.ops.fused import int8_matmul
    return {**_dal_counters(), **_flash_counters(), "int8_matmul": int8_matmul}


def _timed_forward(fn, counters, per_call, what) -> dict:
    """One warm-up and ``PTQ_TIMED`` timed calls of ``fn`` under
    ``torch.no_grad()``, the counters set to 0 first and each held at
    ``per_call`` a call; ms a call by the host clock ended by
    ``torch.cuda.synchronize()``, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PTQ_TIMED):
            out = fn()
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    calls = PTQ_TIMED + 1
    launches = {n: c.launches for n, c in counters.items()}
    for n, count in launches.items():
        if count != per_call.get(n, 0) * calls:
            raise AssertionError(f"{what}: {n} launched {count} times in "
                                 f"{calls} calls, want {per_call.get(n, 0)} "
                                 f"a call")
    return {"out": out, "ms": 1e3 * dt / PTQ_TIMED, "launches": launches,
            "calls": calls,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}


def phase_ptq_encoder() -> dict:
    """``encoder_train``'s 24-layer stack (same seed, bf16) in eval mode:
    the bf16 forward, then ``PTQ(QuantConfig())`` and the same forward
    in int8, each timed and profiled once."""
    from paddle_ray_tpu_torch.quantization import PTQ, QuantConfig
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = _encoder_stack(ENC_LAYERS, "bfloat16", g).eval()
    b, s = ENC_BATCH, ENC_SEQ
    src = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    valid = _padding_mask(ENC_LENGTHS, s)
    src_mask = valid[:, None, None, :]
    counters = _forward_counters()
    per = {"fused_dropout_add_layernorm": 2 * ENC_LAYERS,
           "flash_attention_fwd": ENC_LAYERS}
    runs = {"bf16": _timed_forward(lambda: model(src, src_mask), counters,
                                   per, "ptq_encoder bf16")}
    groups = {"int8_matmul": ("int8_matmul",), "flash": ("flash_",),
              "dropout_add_layernorm": ("dal_fwd",),
              "matmul": ("gemm", "nvjet"),
              "elementwise_and_reductions": ("elementwise", "reduce")}
    with torch.no_grad():
        _profile_step(lambda: model(src, src_mask), "ptq_encoder_profile",
                      runs["bf16"]["ms"], groups)
    ptq = PTQ(QuantConfig())
    model = ptq.convert(ptq.quantize(model))
    per["int8_matmul"] = 4 * ENC_LAYERS
    runs["int8"] = _timed_forward(lambda: model(src, src_mask), counters,
                                  per, "ptq_encoder int8")
    with torch.no_grad():
        _profile_step(lambda: model(src, src_mask), "ptq_encoder_profile",
                      runs["int8"]["ms"], groups)
    ref = runs["bf16"].pop("out")[valid].float()
    got = runs["int8"].pop("out")[valid].float()
    if not torch.isfinite(got).all():
        raise AssertionError("ptq_encoder: int8 output not finite")
    rel = _rel_err(got, ref)
    cos = float(torch.nn.functional.cosine_similarity(
        got.flatten(), ref.flatten(), dim=0))
    for r in runs.values():
        r["tokens_per_s"] = b * s / (r["ms"] / 1e3)
    emit("ptq_encoder", layers=ENC_LAYERS, d_model=ENC_D, heads=ENC_HEADS,
         ffn=ENC_FFN, batch=b, seq=s, lengths=list(ENC_LENGTHS),
         timed_calls=PTQ_TIMED, int8_vs_bf16_rel_err=rel,
         int8_vs_bf16_cosine=cos, **runs)
    out = {"launches": runs["int8"]["launches"]["int8_matmul"],
           "ms": {k: r["ms"] for k, r in runs.items()}}
    del model, src
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 22. correctness of the PTQ path on the card
# ---------------------------------------------------------------------------
def phase_ptq_check() -> None:
    """A 4-layer float32 stack of the encoder's width, TF32 off, batch 2
    of 512 padded to lengths 512 and 333, quantized on the card and as a
    copy on the CPU (the plain versions).  Exact: the int8 weights and
    scales equal, the first projection (whose input is the same on both
    sides) equal bit for bit inside the forward, and ``QuantizedLinear``
    equal on one shared input.  The stack's outputs agree only within the
    int8 error: flash and the plain attention, and the LayerNorms, sum in
    other orders, so a few activations take the neighbouring int8 step on
    one side; when one of them is a tensor's largest, that tensor's
    per-tensor scale moves and every activation is rounded on a shifted
    grid, and later layers take many steps apart.  The phase measures that
    floor on the CPU alone (the same stack under a 1e-7 relative
    perturbation of its input) and holds the card to ``max|err| /
    max|ref|`` ``PTQ_CHECK_TOL``."""
    from paddle_ray_tpu_torch.ops.fused import int8_matmul
    from paddle_ray_tpu_torch.quantization import quantize_model
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 6)
    models = {"cuda": _encoder_stack(4, "float32", g).eval()}
    models["cpu"] = copy.deepcopy(models["cuda"]).to("cpu")
    models = {dev: quantize_model(m) for dev, m in models.items()}
    b, s, lengths = 2, ENC_SEQ, (512, 333)
    r = np.random.RandomState(SEED + 6)
    x = torch.from_numpy(r.randn(b, s, ENC_D).astype(np.float32))
    x_moved = x * (1 + 1e-7 * torch.from_numpy(
        r.randn(b, s, ENC_D).astype(np.float32)))
    valid = _padding_mask(lengths, s, device="cpu")
    mask = valid[:, None, None, :]
    first = {}

    def keep(dev):
        def hook(mod, inp, out):
            first[dev] = out.cpu()       # returns None: the output stays
        return hook
    hooks = [m.layers[0].fused_attn.qkv.register_forward_hook(keep(dev))
             for dev, m in models.items()]
    int8_matmul.launches = 0
    with torch.no_grad():
        ys = {dev: m(x.to(dev), mask.to(dev)).cpu()
              for dev, m in models.items()}
        for h in hooks:
            h.remove()
        y_moved = models["cpu"](x_moved, mask)
        lin = {dev: m.layers[0].ffn.linear1 for dev, m in models.items()}
        h = torch.from_numpy(r.randn(b * s, ENC_D).astype(np.float32))
        lin_out = {dev: lin[dev](h.to(dev)).cpu() for dev in lin}
    launches = int8_matmul.launches
    if launches != 4 * 4 + 1:
        raise AssertionError(f"ptq_check: int8_matmul launched {launches} "
                             f"times, want 17")
    same_weights = all(torch.equal(a.cpu(), c) for a, c in zip(
        models["cuda"].state_dict().values(),
        models["cpu"].state_dict().values()))
    first_equal = bool(torch.equal(first["cuda"], first["cpu"]))
    linear_equal = bool(torch.equal(lin_out["cuda"], lin_out["cpu"]))
    err = _rel_err(ys["cuda"][valid], ys["cpu"][valid])
    floor = _rel_err(y_moved[valid], ys["cpu"][valid])
    if not (same_weights and first_equal and linear_equal
            and err <= PTQ_CHECK_TOL and torch.isfinite(ys["cuda"]).all()):
        raise AssertionError(
            f"ptq_check: int8 weights equal {same_weights}, first qkv "
            f"bit-equal {first_equal}, QuantizedLinear bit-equal "
            f"{linear_equal}, stack off by {err} (max|err| / max|ref|, "
            f"tolerance {PTQ_CHECK_TOL}; the CPU's own floor {floor})")
    emit("ptq_check", dtype="float32", layers=4, batch=b, seq=s,
         lengths=list(lengths), tf32=False, rel_err=err,
         cpu_perturbed_rel_err=floor, tol=PTQ_CHECK_TOL,
         int8_weights_equal=same_weights, first_qkv_bit_equal=first_equal,
         quantized_linear_bit_equal=linear_equal, launches=launches)
    del models
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 23. QAT of the fused encoder, then its int8 conversion
# ---------------------------------------------------------------------------
def phase_qat() -> dict:
    """``QAT().quantize`` on a 4-layer bf16 stack of the encoder's width:
    ``QAT_STEPS`` ``AdamW(1e-4)`` steps (MSE, ``encoder_train``'s
    per-step keys), losses finite and falling; then ``QAT().convert`` and
    one eval forward, 16 int8 launches."""
    from paddle_ray_tpu_torch.core import prng
    from paddle_ray_tpu_torch.ops.fused import int8_matmul
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    from paddle_ray_tpu_torch.quantization import (QAT, QATLinear,
                                                   QuantizedLinear)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 7)
    qat = QAT()
    model = qat.quantize(_encoder_stack(QAT_LAYERS, "bfloat16", g))
    n_qat = sum(isinstance(m, QATLinear) for m in model.modules())
    b, s = ENC_BATCH, ENC_SEQ
    src = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    target = torch.randn(b, s, ENC_D, generator=g, device="cuda").bfloat16()
    src_mask = _padding_mask(ENC_LENGTHS, s)[:, None, None, :]

    def loss_fn(m, batch, rng):
        x, mask, y = batch
        return ((m(x, mask, rng).float() - y.float()) ** 2).mean()
    ts = build_train_step(model, AdamW(ENC_LR), loss_fn)
    root = prng.PRNGKey(0)
    losses = [float(ts.step((src, src_mask, target), prng.fold_in(root, i)))
              for i in range(QAT_STEPS)]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"qat losses not finite and falling: {losses}")
    model = qat.convert(ts.model).eval()
    n_int8 = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    int8_matmul.launches = 0
    with torch.no_grad():
        y = model(src, src_mask)
    launches = int8_matmul.launches
    if not (launches == 4 * QAT_LAYERS and n_qat == n_int8 == launches
            and torch.isfinite(y).all()):
        raise AssertionError(f"qat: {n_qat} QATLinear, {n_int8} "
                             f"QuantizedLinear, {launches} int8 launches a "
                             f"forward (want {4 * QAT_LAYERS})")
    emit("qat", layers=QAT_LAYERS, d_model=ENC_D, dtype="bfloat16",
         batch=b, seq=s, optimizer=f"AdamW({ENC_LR})", steps=QAT_STEPS,
         losses=losses, qat_linears=n_qat, int8_launches=launches)
    del ts, model
    torch.cuda.empty_cache()
    return {"launches": launches}


def _entry(name, source, replaces, body, launches, case, shape,
           max_abs_err=None) -> dict:
    """One row of the ``kernels`` line: the main path's launches, the
    numbers of one measured case (or of a sum of cases, as built by the
    caller)."""
    return {
        "name": name, "route": "cuda",
        "source": f"paddle_ray_tpu_torch/ops/csrc/{source}",
        "replaces": f"paddle_ray_tpu/ops/{replaces}", "tpu_kernel": body,
        "launches": launches,
        "max_abs_err": (case["max_abs_err"] if max_abs_err is None
                        else max_abs_err),
        "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "library_ms": case["library_ms"], "shape": shape}


def _decode_step_matmuls(matmul, n_layers) -> dict:
    """The int8 matmul launches of one decode step of gpt3-350m (four
    linears a layer and the tied head), their times and bounds summed."""
    count = {"qkv": n_layers, "out": n_layers, "fc1": n_layers,
             "fc2": n_layers, "head": 1}
    step = {k: sum(n * matmul[c][k] for c, n in count.items())
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = sum(n * matmul[c]["bytes"] for c, n in count.items()) \
        / HBM_BYTES_PER_S
    t_ops = sum(n * matmul[c]["ops"] for c, n in count.items()) \
        / PEAK_OPS_PER_S[torch.bfloat16]
    step["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    step["max_abs_err"] = max(r["max_abs_err"] for r in matmul.values())
    return step


def main() -> None:
    smi = phase_device()
    from paddle_ray_tpu_torch.models import build_gpt
    phase_build()
    kernel = phase_kernel()
    flash = phase_flash_kernel()
    decode = phase_decode_kernel()
    gn = phase_gn_kernel()
    dal = phase_dal_kernel()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    serve = phase_serve(model)
    phase_check(model)
    serve_int8 = phase_serve_int8(model)
    gen = phase_generate(model)
    n_layers = model.cfg.num_layers
    del model
    torch.cuda.empty_cache()
    phase_generate_check()
    train = phase_train()
    phase_train_check()
    unet = phase_unet_train()
    phase_unet_check()
    bert = phase_bert_train()
    phase_bert_check()
    enc = phase_encoder_train()
    int8 = phase_int8_mm_kernel()
    ptq = phase_ptq_encoder()
    phase_ptq_check()
    qat = phase_qat()
    train_case = flash["train_bf16"]
    runs = {"gpt": train, "bert": bert, "encoder": enc}
    flash_entries = [_entry(
        name, "flash_attention.cu", f"flash_attention.py:{line}", body,
        sum(r["launches"][name] for r in runs.values()), train_case[kind],
        "bf16 causal, B 8, S 1024, H 16, D 64 (launches: gpt3-350m, "
        "BERT-large and the fused encoder training runs, "
        + ", ".join(f"{r['launches'][name]}" for r in runs.values())
        + "); non-causal B 8, S 512 with segment ids {:.4f} ms, a [B,1,1,S] "
        "mask-bias {:.4f} ms, a full bias{} {:.4f} ms".format(
            *(flash[m][kind]["ms"] for m in FLASH_MODES[:2]),
            " with dbias" if kind == "dq" else "",
            flash[FLASH_MODES[2]][kind]["ms"])
        + ("" if kind == "fwd" else "; library_ms is SDPA's backward, for "
           "dq and dk/dv together"))
        for name, kind, line, body in zip(
            FLASH_KERNELS, ("fwd", "dq", "dkv"), (76, 135, 186),
            ("_fwd_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel"))]
    paged_err = {q8: max(r["max_abs_err"] for r in kernel.values()
                         if r["tol"] == TOL[torch.bfloat16]
                         and r["q8"] == q8) for q8 in (False, True)}
    att = decode["attention"]
    gen_launches = {k: gen[c]["launches_per_call"][k] for c, k in (
        ("bf16", "fused_decode_attention"),
        ("int8", "fused_decode_attention_q8"),
        ("int8", "int8_stream_matmul"))}
    entries = [
        _entry("paged_ragged_attention", "paged_attention.cu",
               "paged_attention.py:108", "_kernel", serve["launches"],
               kernel["decode_2048_bf16"],
               "bf16 decode, 8 slots x 2048 tokens, h=16, d=64, page 64",
               paged_err[False]),
        *flash_entries,
        _entry("paged_ragged_attention_q8", "paged_attention.cu",
               "paged_attention.py:134", "_kernel_q8",
               serve_int8["launches"], kernel["decode_2048_q8_bf16"],
               "int8 pool, bf16 q: decode, 8 slots x 2048 tokens, h=16, "
               "d=64, page 64; library_ms is SDPA over the dequantised "
               "cache", paged_err[True]),
        _entry("fused_decode_attention", "decode_attention.cu",
               "decode_attention.py:71", "_kernel_bf16",
               gen_launches["fused_decode_attention"], att["bf16_pos255"],
               "bf16, B 8, h 16, d 64, pos 255 of a 512-row cache (the "
               "middle of generate()'s decode positions 128..382)",
               max(r["max_abs_err"] for k, r in att.items()
                   if k.startswith("bf16"))),
        _entry("fused_decode_attention_q8", "decode_attention.cu",
               "decode_attention.py:88", "_kernel_q8",
               gen_launches["fused_decode_attention_q8"], att["q8_pos255"],
               "int8 cache, bf16 q, B 8, h 16, d 64, pos 255 of a 512-row "
               "cache; library_ms is SDPA over the dequantised cache",
               max(r["max_abs_err"] for k, r in att.items()
                   if k.startswith("q8"))),
        _entry("int8_stream_matmul", "decode_matmul.cu",
               "decode_matmul.py:27", "_kernel",
               gen_launches["int8_stream_matmul"],
               _decode_step_matmuls(decode["matmul"], n_layers),
               "one decode step of gpt3-350m at batch 8, bf16 x: 24 x "
               "(1024->3072, 1024->1024, 1024->4096, 4096->1024, with bias) "
               "+ the 1024->50304 head, 97 launches summed"),
    ]
    gn_case = gn["cases"][(UNET_IMG * UNET_IMG, 320, "mod")]
    gn_shape = (f"bf16 [{UNET_BATCH}, {UNET_IMG}, {UNET_IMG}, 320], 32 "
                f"groups, scale+shift+silu (the step's {gn['calls']} calls "
                f"sum to {{:.4f}} ms against a {{:.4f}} ms bound); "
                f"library_ms is torch.nn.functional.group_norm alone on the "
                f"channels-last NCHW view")
    entries += [
        _entry(name, "groupnorm.cu", f"groupnorm.py:{line}", body,
               unet["launches"][name], gn_case[kind],
               gn_shape.format(gn["step"][kind]["ms"],
                               gn["step"][kind]["bound_ms"])
               + ("" if kind == "fwd" else ", its autograd backward"))
        for name, kind, line, body in zip(
            GN_KERNELS, ("fwd", "bwd"), (48, 109),
            ("_fwd_kernel", "_bwd_kernel"))]
    dal_case = dal["encoder_bf16_p0.1"]
    entries += [
        _entry(name, "fused.cu", f"fused.py:{line}", body,
               enc["launches"][name], dal_case[kind],
               f"bf16 [{ENC_BATCH} x {ENC_SEQ}, {ENC_D}], p {ENC_RATE}, "
               f"training, h unused (the fused encoder's post-LN call); "
               f"library_ms is torch.nn.functional.layer_norm on h alone"
               + ("" if kind == "fwd" else ", its autograd backward"))
        for name, kind, line, body in zip(
            DAL_KERNELS, ("fwd", "bwd"), (95, 116),
            ("_dal_fwd_kernel", "_dal_bwd_kernel"))]
    fwd = _int8_forward_sum(int8, ENC_LAYERS)
    entries.append(_entry(
        "int8_matmul", "int8_matmul.cu", "fused.py:320", "_int8_mm_kernel",
        ptq["launches"] + qat["launches"], int8["linear1"],
        f"float32 out, [{ENC_BATCH} x {ENC_SEQ}, {ENC_D}] x [{ENC_D}, "
        f"{ENC_FFN}] (the fused encoder's linear1); the 24-layer PTQ "
        f"forward's 96 launches sum to {fwd['ms']:.4f} ms against a "
        f"{fwd['bound_ms']:.4f} ms bound ({fwd['bound_by']}); launches: "
        f"ptq_encoder's {ptq['launches']} and qat's {qat['launches']}; "
        f"library_ms is torch._int_mm then the two scale products"))
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
