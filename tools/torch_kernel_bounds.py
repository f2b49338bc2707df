"""The least time an NVIDIA H100 could take for each TPU kernel the port
has not ported yet, at the shape its JAX caller in ``bench.py`` gives it.

Pure arithmetic from the shapes (no card needed): bytes -- each input
read once, each output written once -- over the HBM rate, against
operations over the peak of the type the products run in, the larger of
the two (the rule ``chip_smoke.py`` applies to the ported kernels).  Prints
one JSON line per kernel.  Run from the repository root::

    python3 tools/torch_kernel_bounds.py
"""
from __future__ import annotations

import json

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK = {"bf16": 989e12, "int8": 1979e12}

# shapes of bench.py's callers
HIDDEN = 1024                                  # gpt3-350m
ROWS_TRAIN = 8 * 1024                          # bench_gpt(350m): batch 8 x seq 1024


def bound(name, body, caller, shape, n_bytes, ops, peak="bf16"):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK[peak]
    return {"kernel": name, "body": body, "caller": caller, "shape": shape,
            "bytes": n_bytes, "ops": ops, "peak": peak,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rows():
    m, k, n = ROWS_TRAIN, HIDDEN, 4 * HIDDEN
    yield bound(
        "int8_matmul", "_int8_mm_kernel fused.py:320",
        "no caller; gpt3-350m's fc1 at the training batch",
        f"[{m}, {k}] x [{k}, {n}] int8 -> f32",
        m * k + k * n + m * n * 4 + (m + n) * 4, 2 * m * n * k, peak="int8")


if __name__ == "__main__":
    for row in rows():
        print(json.dumps(row))
