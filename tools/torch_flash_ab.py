"""A/B of the flash-attention kernels of two trees of this repository on one
card: the tree this script lives in against another (an earlier commit,
unpacked with ``git archive``), one process per turn in the order other,
this, this, other.  Each turn builds its tree's kernels and times its
``flash_forward``, ``flash_backward_dq`` and ``flash_backward_dkv`` at
GPT-3 350m's training shape (bf16, causal, B 8, S 1024, H 16, D 64) with
its tree's ``chip_smoke.time_ms`` (median of 50, L2 flushed).  Prints one
JSON line per turn and the card's name and power limit.  Run from the
repository root on a machine with a CUDA card::

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
g = torch.Generator(device="cuda")
g.manual_seed(0)
b, s, h, d = 8, 1024, 16, 64
q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda")
               .bfloat16() for _ in range(4))
kw = dict(causal=True, scale=d ** -0.5)
o, lse = fa.flash_forward(q, k, v, **kw)
delta = (o.float() * do.float()).sum(-1)
t = chip_smoke.time_ms
print(json.dumps({
    "fwd": t(lambda: fa.flash_forward(q, k, v, **kw), iters=50),
    "dq": t(lambda: fa.flash_backward_dq(q, k, v, do, lse, delta, **kw),
            iters=50),
    "dkv": t(lambda: fa.flash_backward_dkv(q, k, v, do, lse, delta, **kw),
             iters=50)}))
'''


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 tools/torch_flash_ab.py OTHER_TREE")
    trees = {"other": os.path.abspath(sys.argv[1]), "this": ROOT}
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, "-c", TURN, trees[name]],
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
