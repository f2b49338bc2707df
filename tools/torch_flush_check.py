"""How the L2 cache's state before a launch moves the times of fused decode
attention, the dropout-add-LayerNorm forward and their library yardsticks.

``chip_smoke.time_ms`` flushes the 50 MB L2 by writing 64 MB of zeros
before every timed launch, so the L2 holds dirty lines whose write-back
to device memory falls inside the timed window of the next kernel: every
byte a kernel brings into L2 can cost a byte written back as well.  This
script times each case three ways, in one process on one card:

* ``zero``: ``chip_smoke.time_ms`` as every other number in ``PERF.md``;
* ``read``: the same, but the flush reads 64 MB (a sum), leaving L2 full of
  clean lines;
* ``warm``: no flush (the inputs of a small case may sit in L2);

and a one-element add under each, the floor of the timing itself.  The
cases are ``chip_smoke.DEC_ATTN_CASES`` at pos 255 and at the long
single-stream position, and ``chip_smoke.DAL_CASES``' encoder case (its
forward, its backward, and ``F.layer_norm`` on h).  Prints one JSON line
per case and the card's name and power limit.  Run from the repository
root on a machine with a CUDA card::

    python3 tools/torch_flush_check.py
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


def _modes(fn) -> dict:
    buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    return {mode: chip_smoke.time_ms(fn, iters=50, flush=flush)
            for mode, flush in (
                ("zero", "zero"),
                ("read", lambda: torch.sum(buf, dtype=torch.int64)),
                ("warm", None))}


def main() -> None:
    import torch.nn.functional as F
    from paddle_ray_tpu_torch.ops import fused
    from paddle_ray_tpu_torch.ops.decode_attention import (
        fused_decode_attention)
    if not torch.cuda.is_available():
        raise SystemExit("torch_flush_check: no CUDA card")
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"case": "one_element_add",
                      **_modes(lambda: one.add_(1.0))}), flush=True)
    for name, kind, dtype, b, h, d, t_len, positions in \
            chip_smoke.DEC_ATTN_CASES:
        pos = positions[-1] if name.startswith("long") else 255
        if pos not in positions or kind == "f32":
            continue
        dt = getattr(torch, dtype)
        q, cache = chip_smoke._decode_attention_inputs(kind, dt, b, h, d,
                                                       t_len)
        if kind == "q8":
            kq, ks, vq, vs = cache
            kd, vd = (kq.float() * ks).to(dt), (vq.float() * vs).to(dt)
        else:
            kd, vd = cache
        kd = kd[:, :, :pos + 1].contiguous()
        vd = vd[:, :, :pos + 1].contiguous()
        scale = d ** -0.5
        print(json.dumps({
            "case": f"decode_{name}_pos{pos}",
            "kernel": _modes(lambda: fused_decode_attention(
                q, cache, pos, scale=scale)),
            "sdpa": _modes(lambda: F.scaled_dot_product_attention(
                q, kd, vd, scale=scale))}), flush=True)
        del q, cache, kd, vd
    name, rows, hd, dtype, p, training, _, _ = chip_smoke.DAL_CASES[0]
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(rows + hd)
    x, res, dy = (torch.randn(rows, hd, generator=g, device="cuda").to(dt)
                  for _ in range(3))
    w = (1.0 + 0.2 * torch.randn(hd, generator=g, device="cuda")).to(dt)
    b = (0.2 * torch.randn(hd, generator=g, device="cuda")).to(dt)
    kw = dict(p=p, training=training)
    _, hh, mean, rstd = fused.dal_forward(x, res, w, b, 12345, **kw)
    print(json.dumps({
        "case": f"dal_{name}",
        "fwd": _modes(lambda: fused.dal_forward(x, res, w, b, 12345, **kw)),
        "bwd": _modes(lambda: fused.dal_backward(hh, mean, rstd, w, dy,
                                                 None, 12345, **kw)),
        "layer_norm": _modes(lambda: F.layer_norm(hh, (hd,), w, b, 1e-5))}),
        flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
