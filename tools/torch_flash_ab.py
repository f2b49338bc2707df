"""A/B of the flash-attention kernels of two trees of this repository on one
card: the tree this script lives in against another (an earlier commit,
unpacked with ``git archive``), one process per turn in the order other,
this, this, other.  Each turn builds its tree's kernels and times its
``flash_forward``, ``flash_backward_dq`` and ``flash_backward_dkv`` with its
tree's ``chip_smoke.time_ms`` (median of 50, L2 flushed) at every bfloat16
shape of this tree's ``chip_smoke.FLASH_CASES`` and ``FLASH_MODES``: GPT-3
350m's training shape (causal, B 8, S 1024, H 16, D 64) first, then head
dim 128, gpt3-760m's D 96, gpt3-2.7b's D 80, GQA, a ragged S 320, and the
B 8, S 512 masking modes (segment ids, a [B, 1, 1, S] mask-bias, a full bias
with dbias, causal segment ids with fully masked rows).  A shape a tree's
kernels refuse (a head dim it was not built for) is reported as null.
Prints one JSON line per turn and the card's name and power limit.  Run
from the repository root on a machine with a CUDA card::

    mkdir -p archive_check/parent
    git archive <commit> | tar -x -C archive_check/parent
    python3 tools/torch_flash_ab.py archive_check/parent
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r'''
import importlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
fa = importlib.import_module("paddle_ray_tpu_torch.ops.flash_attention")
t = chip_smoke.time_ms
out = {}
for name, b, s, h, hkv, d, causal, mode in json.loads(sys.argv[2]):
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, do = (torch.randn(b * h, s, d, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b * hkv, s, d, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5)
    lengths = torch.linspace(288, s, b, device="cuda").long()
    valid = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    seg = valid.to(torch.int32).contiguous()
    if mode == "segments":
        kw["segment_ids"] = (seg, seg)
    elif mode == "mask_bias":
        kw["bias"] = torch.where(valid, 0.0, -1e30)[:, None, None, :].float(
        ).expand(b, h, s, s)
    elif mode == "bias_dbias":
        kw["bias"] = torch.randn(b, h, s, s, generator=g, device="cuda")
    elif mode == "causal_segments":
        lonely = seg.clone()
        lonely[0, json.loads(sys.argv[3])] = 2
        kw["segment_ids"] = (lonely, seg)
    need = mode == "bias_dbias"
    try:
        o, lse = fa.flash_forward(q, k, v, **kw)
    except ValueError:  # a head dim this tree's kernels do not take
        out[name] = None
        continue
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    out[name] = {
        "fwd": t(lambda: fa.flash_forward(q, k, v, **kw), iters=50),
        "dq": t(lambda: fa.flash_backward_dq(*bwd, need_dbias=need, **kw),
                iters=50),
        "dkv": t(lambda: fa.flash_backward_dkv(*bwd, **kw), iters=50)}
print(json.dumps(out))
'''


def _cases() -> tuple:
    """This tree's bf16 cases and modes, and the rows the causal-segments
    mode leaves no visible key."""
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    cases = [[name, b, s, h, hkv, d, causal, None]
             for name, b, s, h, hkv, d, dtype, causal in chip_smoke.FLASH_CASES
             if dtype == torch.bfloat16]
    b, s, h = chip_smoke.ENC_BATCH, chip_smoke.ENC_SEQ, chip_smoke.ENC_HEADS
    for mode in chip_smoke.FLASH_MODES:
        cases.append([mode, b, s, h, h, 64, mode.startswith("causal"),
                      mode[:-len("_bf16")]])
    return cases, list(chip_smoke.LONELY_ROWS)


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 tools/torch_flash_ab.py OTHER_TREE")
    trees = {"other": os.path.abspath(sys.argv[1]), "this": ROOT}
    cases, lonely = (json.dumps(x) for x in _cases())
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, "-c", TURN, trees[name], cases,
                               lonely],
                              cwd=trees[name], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode:
            raise SystemExit(f"{name} turn failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **row}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
