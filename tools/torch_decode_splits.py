"""Fused decode attention by split count: where split-K over a pair's rows
pays for its merge.

For gpt3-350m's heads (16 of 64) at batch 1, 2, 4 and 8 over a bf16 cache,
at batch 1 over int8 and float32 caches, and at batch 1 at gpt3-760m's
(16 of 96) and gpt3-2.7b's (32 of 80) in bf16, times the kernel over cache
lengths with the rows cut into 1, 2, 4, 8 and 16 splits (whole 32-row
groups, none empty) and with ``kernel_plan``'s own split (``planned``), each with the
L2 flushed (``chip_smoke.time_ms``) and warm, and reports each split's
largest difference from the unsplit output.  Prints one JSON line per
(case, length) and the card's name and power limit.  Run from the
repository root on a machine with a CUDA card::

    python3 tools/torch_decode_splits.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

LENGTHS = (64, 128, 192, 256, 384, 512, 768, 1024, 2048, 4096)
SPLITS = (1, 2, 4, 8, 16)
# (name, cache kind, q dtype, batches, heads, head dim)
CASES = (("bf16", "bf16", "bfloat16", (1, 2, 4, 8), 16, 64),
         ("q8", "q8", "bfloat16", (1,), 16, 64),
         ("f32", "f32", "float32", (1,), 16, 64),
         ("bf16_d96", "bf16", "bfloat16", (1,), 16, 96),
         ("bf16_d80", "bf16", "bfloat16", (1,), 32, 80))


def main() -> None:
    from paddle_ray_tpu_torch.ops import decode_attention as da
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_splits: no CUDA card")
    planned = da.kernel_plan
    for name, kind, dtype, batches, h, d in CASES:
        dt = getattr(torch, dtype)
        for b in batches:
            q, cache = chip_smoke._decode_attention_inputs(
                kind, dt, b, h, d, max(LENGTHS))
            for n_live in LENGTHS:
                pos, groups = n_live - 1, -(-n_live // da.ROW_GROUP)
                plans = {}                   # "1" first: the reference
                for n in SPLITS:
                    per = -(-groups // n)
                    if n <= groups and -(-groups // per) == n:
                        plans[str(n)] = (n, per * da.ROW_GROUP)
                plans["planned"] = planned(q, pos)
                row = {"case": name, "batch": b, "heads": h, "d": d,
                       "n_live": n_live, "plan": list(plans["planned"])}
                ref = None
                for label, plan in plans.items():
                    da.kernel_plan = lambda q_, p_, plan=plan: plan
                    try:
                        call = lambda: da.fused_decode_attention(  # noqa
                            q, cache, pos, scale=d ** -0.5)
                        out = call().float()
                        ref = out if ref is None else ref
                        row[label] = {
                            "ms": chip_smoke.time_ms(call),
                            "warm_ms": chip_smoke.time_ms(call, flush=None),
                            "max_abs_diff": float((out - ref).abs().max())}
                    finally:
                        da.kernel_plan = planned
                print(json.dumps(row), flush=True)
            del q, cache
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
