"""The weight-streaming int8 matmul by split count: where split-K over K
pays for its in-launch merge.

At every case of ``chip_smoke.matmul_cases`` (gpt3-350m's decode linears
and LM head at batch 8, float32 x, N = 97, 1 and 128 rows), times
``int8_stream_matmul`` with K cut into 1, 2, 4, 8, 16, 32 and 64 runs
(whole 64-row stages, none empty) and with ``kernel_plan``'s own cut
(``planned``), each with the L2 flushed (``chip_smoke.time_ms``) and warm,
and reports each cut's largest difference from the unsplit output.
Prints one JSON line per case, then the timing's floor (a one-element
add) and the card's name and power limit.  Run from the repository root
on a machine with a CUDA card::

    python3 tools/torch_stream_splits.py
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

SPLITS = (1, 2, 4, 8, 16, 32, 64)


def main() -> None:
    from paddle_ray_tpu_torch.ops import decode_matmul as dm
    if not torch.cuda.is_available():
        raise SystemExit("torch_stream_splits: no CUDA card")
    planned = dm.kernel_plan
    for name, b, k, n, with_bias, dtype in chip_smoke.matmul_cases():
        x, w_q, scale, bias = chip_smoke.matmul_inputs(b, k, n, with_bias,
                                                       dtype)
        stages = -(-k // dm.STAGE_K)
        plans = {}                       # "1" first: the reference
        for s in SPLITS:
            rows = -(-stages // s) * dm.STAGE_K
            if -(-k // rows) == s:
                plans[str(s)] = (rows, s)
        plans["planned"] = planned(b, k, n, x.device)
        row = {"case": name, "shape": [b, k, n], "dtype": str(dtype),
               "plan": list(plans["planned"]),
               "bound_ms": chip_smoke._matmul_bound(
                   b, k, n, dtype,
                   None if bias is None else bias.dtype)["bound_ms"]}
        ref = None
        for label, plan in plans.items():
            dm.kernel_plan = lambda *a, plan=plan: plan
            try:
                call = lambda: dm.int8_stream_matmul(  # noqa: E731
                    x, w_q, scale, bias)
                out = call().float()
                ref = out if ref is None else ref
                row[label] = {
                    "ms": chip_smoke.time_ms(call),
                    "warm_ms": chip_smoke.time_ms(call, flush=None),
                    "max_abs_diff": float((out - ref).abs().max())}
            finally:
                dm.kernel_plan = planned
        print(json.dumps(row), flush=True)
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"floor_ms": chip_smoke.time_ms(lambda: one.add_(1)),
                      "floor_warm_ms": chip_smoke.time_ms(
                          lambda: one.add_(1), flush=None)}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
