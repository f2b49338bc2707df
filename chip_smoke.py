"""Chip smoke test of the PyTorch / CUDA port (``paddle_ray_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device  -- the card, from ``nvidia-smi`` and torch; exits non-zero
   without CUDA.
2. build   -- builds every kernel source under
   ``paddle_ray_tpu_torch/ops/csrc/`` with ``nvcc`` (one process per
   source, all started together).
3. kernel  -- each kernel against its plain PyTorch version at the shapes
   the serving path gives it (float32 ``atol=1e-4``, bfloat16
   ``atol=2e-2``, null page poisoned), timed with CUDA events beside its
   bound and one PyTorch library call on the same inputs.
4. serve   -- GPT-3 350m (bf16, random weights from seed 0) served by the
   port's ``ServingEngine`` through the 12-request mixed-length workload
   of ``bench.py:bench_serving``; every request must return its full
   budget, and the paged-attention kernel must have been launched once
   per layer per step.
5. check   -- two requests through an engine on a float32 copy of the
   weights, against greedy decoding by plain ``GPT.forward``.

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

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # tensor cores, bf16
                  torch.float32: 67e12}     # CUDA cores, fp32
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

MODEL = "gpt3-350m"
PAGE, MAX_BATCH, SEED = 64, 8, 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` (ms), with the 50 MB L2 flushed
    before every timed launch: the serving path reads each layer's pages
    cold."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
                    h_kv=16, d=64, blocks=32, seed=0):
    """Inputs at the serving path's shapes: 8 slots, pages of 64 rows
    scattered over a 1 + 8 * 32 page pool, page 0 poisoned."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b = len(q_lens)
    n = 1 + b * blocks
    k = torch.randn(n, PAGE, h_kv, d, generator=g, device="cuda")
    v = torch.randn(n, PAGE, h_kv, d, generator=g, device="cuda")
    k[0] = 1e4
    v[0] = 1e4
    perm = torch.randperm(n - 1, generator=g, device="cuda") + 1
    table = perm.reshape(b, blocks).to(torch.int32)
    q = torch.randn(b, width, h_q, d, generator=g, device="cuda")
    return dict(name=name, q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                table=table,
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device="cuda"),
                q_lens=torch.tensor(q_lens, dtype=torch.int32,
                                    device="cuda"))


def _attention_bound(c) -> dict:
    """The least time for this call's work: bytes (q and out once, the K/V
    rows the live slots own once, table and lengths) over the HBM rate,
    and 4 * (visible keys) * h_q * d operations over the peak for the
    inputs' type; the larger of the two."""
    q, k = c["q"], c["k"]
    es = q.element_size()
    _, _, h_q, d = q.shape
    h_kv = k.shape[2]
    lengths = c["lengths"].tolist()
    q_lens = c["q_lens"].tolist()
    rows = sum(ln for ln, ql in zip(lengths, q_lens) if ln > 0 and ql > 0)
    n_bytes = (2 * q.numel() * es + 2 * rows * h_kv * d * es
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
    timed call) and the ragged causal mask as a boolean ``[B, 1, C, T]``."""
    q, k, v, table = c["q"], c["k"], c["v"], c["table"]
    b, width, h_q, d = q.shape
    h_kv = k.shape[2]
    t_len = table.shape[1] * PAGE
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
    scale = 1.0 / 64 ** 0.5
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
        ]
    cases.append(_attention_case("decode_2048_bf16", dtype=torch.bfloat16,
                                 **decode_2048))
    results = {}
    for c in cases:
        args = (c["q"], (c["k"], c["v"]), c["table"], c["lengths"],
                c["q_lens"])
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
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: paged_ragged_attention(*args, scale=scale)),
            "plain_ms": time_ms(lambda: paged_ragged_attention_plain(
                *args, scale=scale), iters=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, scale=scale)),
            **_attention_bound(c),
        }
        results[c["name"]] = r
        emit("kernel", kernel="paged_ragged_attention", case=c["name"],
             shape=list(c["q"].shape), h_kv=c["k"].shape[2],
             lengths=c["lengths"].tolist(), q_lens=c["q_lens"].tolist(), **r)
        del qs, kd, vd, mask
    return results


# ---------------------------------------------------------------------------
# 4. the main path: serving gpt3-350m
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
# 5. correctness of the main path on the card
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


def main() -> None:
    smi = phase_device()
    from paddle_ray_tpu_torch.models import build_gpt
    phase_build()
    kernel = phase_kernel()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = build_gpt(MODEL, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    serve = phase_serve(model)
    phase_check(model)
    main_case = kernel["decode_2048_bf16"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "paged_ragged_attention",
        "route": "cuda",
        "source": "paddle_ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "paddle_ray_tpu/ops/paged_attention.py:108",
        "tpu_kernel": "_kernel",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()
                           if r["tol"] == TOL[torch.bfloat16]),
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "bf16 decode, 8 slots x 2048 tokens, h=16, d=64, page 64",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
