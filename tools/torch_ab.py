"""A/B of the kernels of two trees of this repository on one card:
the tree this script lives in against another (an earlier commit, unpacked
with ``git archive``), one process per turn in the order other, this, this,
other.  Each turn builds its tree's kernels and times them with its tree's
``chip_smoke.time_ms`` (median of 50, L2 flushed) at this tree's cases:

* ``flash``: ``flash_forward``, ``flash_backward_dq`` and
  ``flash_backward_dkv`` at every bfloat16 shape of ``chip_smoke``'s
  ``FLASH_CASES`` and ``FLASH_MODES``: GPT-3 350m's training shape (causal,
  B 8, S 1024, H 16, D 64) first, then head dim 128, gpt3-760m's D 96,
  gpt3-2.7b's D 80, GQA, a ragged S 320, and the B 8, S 512 masking modes
  (segment ids, a [B, 1, 1, S] mask-bias, a full bias with dbias, causal
  segment ids with fully masked rows);
* ``paged``: ``paged_ragged_attention`` at every case of
  ``chip_smoke.paged_cases``, over pools in q's dtype and int8 pools, the
  inputs made by each turn's own ``chip_smoke._attention_case`` (page 0
  poisoned); a tree whose wrapper takes ``host_lengths`` gets them;
* ``dal``: ``dal_forward`` and ``dal_backward`` (from the turn's own
  forward's h and statistics) at every case of ``chip_smoke.DAL_CASES``:
  the fused encoder's ``[4096, 1024]`` bf16, p 0.1 first, float32, odd
  rows, widths 768, 8192 and 1020 / 1022;
* ``decode``: ``fused_decode_attention`` at every case and position of
  ``chip_smoke.DEC_ATTN_CASES`` (bf16, float32 and int8 caches at
  gpt3-350m's batch-8 decode, bf16 and int8 at head dims 96 and 80, and
  one stream at the end of a 2048-row cache, bf16, int8 and float32);
* ``int8mm``: the int8 matmul at the fused encoder's four linears and
  gpt3-350m's fc1 at 8192 rows (float32 out, ``int8_mm``; on the K-major
  weight where the tree's ``int8_mm`` takes one, made outside the timing,
  as its ``QuantizedLinear`` keeps it), and the tree's whole
  ``QuantizedLinear`` call at the four linears (bf16 x, bf16 bias: the
  per-tensor quantize, the product, and whatever bias add and cast the
  tree makes apart from it);
* ``stream``: ``int8_stream_matmul`` at every case of
  ``chip_smoke.matmul_cases`` (gpt3-350m's decode linears and LM head at
  batch 8, float32 x, N = 97, 1 and 128 rows);
* ``gn``: ``fused_group_norm_fwd`` and ``fused_group_norm_bwd`` (from the
  turn's own forward's statistics) at every (rows, C, mode) of the SD-UNet
  step at batch 32 in bf16, and ``chip_smoke.GN_EXTRA_CASES`` but the
  misaligned view (float32, odd rows, other group counts, C 36, a slice
  past a cluster's shared memory); each turn also sums the step's 56 calls
  of each kernel;
* ``unet``: the SD-UNet training step of the tree's own
  ``chip_smoke.phase_unet_train`` (``bench.py:bench_unet``'s model, bf16,
  batch 32 of 64x64x4, AdamW; 2 warm-up and 10 timed steps, then one
  profiled step): step ms, images/s, the profiled step's device ms, idle
  share and GroupNorm kernel ms (forward, backward);
* ``serve``: the tree's own ``chip_smoke.phase_serve`` (gpt3-350m, bf16,
  ``bench.py:bench_serving``'s 12 requests through the tree's
  ``ServingEngine``, its default synchronous loop), twice, the second
  run's decode and prefill tokens/s, p50 / p99 step ms, steps and wall
  seconds (both trees' paged kernel built together first);
* ``train``: the tree's own ``chip_smoke.phase_train`` (gpt3-350m, bf16,
  flash, batch 8 x 1024, AdamW), ``phase_bert_train`` (BERT-large, batch
  8 x 512) and ``phase_encoder_train`` (24 fused encoder layers, batch 8
  x 512): each step ms, tokens/s and its profiled step's device ms and
  idle share; then the host time of one call of the tree's
  ``flash_attention`` at a shape whose kernels take a few microseconds
  (bf16, causal, B 1, S 128, H 1, D 64), forward alone and forward with
  backward, the mean of ``FLASH_HOST_CALLS`` calls after a warm-up.

The inputs of ``dal``, ``decode``, ``int8mm``, ``stream`` and ``gn`` are made from
a seed by this script, the same in every turn.  A shape a tree's kernels refuse (a head dim it was
not built for) is reported as null.  Prints one JSON line per turn and the
card's name and power limit.  Run from the repository root on a machine
with a CUDA card::

    mkdir -p archive_check/parent
    git archive <commit> | tar -x -C archive_check/parent
    python3 tools/torch_ab.py flash archive_check/parent
    python3 tools/torch_ab.py paged archive_check/parent
    python3 tools/torch_ab.py dal archive_check/parent
    python3 tools/torch_ab.py decode archive_check/parent
    python3 tools/torch_ab.py int8mm archive_check/parent
    python3 tools/torch_ab.py stream archive_check/parent
    python3 tools/torch_ab.py gn archive_check/parent
    python3 tools/torch_ab.py unet archive_check/parent
    python3 tools/torch_ab.py train archive_check/parent
    python3 tools/torch_ab.py serve archive_check/parent
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: the tree, this tree's cases (JSON), the rows the causal-segments
# mode leaves no visible key (JSON)
FLASH_TURN = r'''
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

# argv: the tree, this tree's cases (JSON: name and keyword arguments of
# _attention_case, the dtype by name)
PAGED_TURN = r'''
import importlib, inspect, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
pa = importlib.import_module("paddle_ray_tpu_torch.ops.paged_attention")
takes_host = "host_lengths" in inspect.signature(
    pa.paged_ragged_attention).parameters
out = {}
for name, kw in json.loads(sys.argv[2]):
    c = chip_smoke._attention_case(
        name, **dict(kw, dtype=getattr(torch, kw["dtype"])))
    extra = dict(host_lengths=kw["lengths"]) if takes_host else {}
    fn = lambda: pa.paged_ragged_attention(
        c["q"], c["pool"], c["table"], c["lengths"], c["q_lens"],
        scale=1.0 / c["q"].shape[-1] ** 0.5, **extra)
    try:
        fn()
    except ValueError:  # a head dim this tree's kernels do not take
        out[name] = None
        continue
    out[name] = chip_smoke.time_ms(fn, iters=50)
    del c
print(json.dumps(out))
'''


# argv: the tree, this tree's DAL_CASES (JSON)
DAL_TURN = r'''
import importlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
fu = importlib.import_module("paddle_ray_tpu_torch.ops.fused")
t = chip_smoke.time_ms
out = {}
for name, rows, h, dtype, p, training, dh2, _ in json.loads(sys.argv[2]):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(rows + h)
    r = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    x, res, dy = (r(rows, h).to(dt) for _ in range(3))
    d2 = r(rows, h).to(dt) if dh2 else None
    w, b = (1.0 + 0.2 * r(h)).to(dt), (0.2 * r(h)).to(dt)
    kw = dict(p=p, training=training)
    _, hh, mean, rstd = fu.dal_forward(x, res, w, b, 12345, epsilon=1e-5,
                                       **kw)
    out[name] = {
        "fwd": t(lambda: fu.dal_forward(x, res, w, b, 12345, epsilon=1e-5,
                                        **kw), iters=50),
        "bwd": t(lambda: fu.dal_backward(hh, mean, rstd, w, dy, d2, 12345,
                                         **kw), iters=50)}
    del x, res, dy, d2, hh
print(json.dumps(out))
'''

# argv: the tree, this tree's DEC_ATTN_CASES (JSON)
DECODE_TURN = r'''
import importlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from paddle_ray_tpu_torch.models.generation import _kv_quant
da = importlib.import_module("paddle_ray_tpu_torch.ops.decode_attention")
out = {}
for name, kind, dtype, b, h, d, t_len, positions in json.loads(sys.argv[2]):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q = torch.randn(b, h, 1, d, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(b, h, t_len, d, generator=g, device="cuda")
            for _ in range(2))
    cache = ((*_kv_quant(k), *_kv_quant(v)) if kind == "q8"
             else (k.to(dt), v.to(dt)))
    for pos in positions:
        fn = lambda: da.fused_decode_attention(q, cache, pos,
                                               scale=d ** -0.5)
        try:
            fn()
        except ValueError:  # a head dim this tree's kernel does not take
            out[f"{name}_pos{pos}"] = None
            continue
        out[f"{name}_pos{pos}"] = chip_smoke.time_ms(fn, iters=50)
print(json.dumps(out))
'''


# argv: the tree, this tree's int8 cases (JSON: name, M, K, N, form)
INT8MM_TURN = r'''
import importlib, inspect, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
fu = importlib.import_module("paddle_ray_tpu_torch.ops.fused")
quant = importlib.import_module("paddle_ray_tpu_torch.quantization.quant")
k_major = "k_major" in inspect.signature(fu.int8_mm).parameters
out = {"k_major": k_major}
for name, m, k, n, form in json.loads(sys.argv[2]):
    g = torch.Generator(device="cuda")
    g.manual_seed(m + k + n)
    xq = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    xs = torch.rand(m, generator=g, device="cuda") * 1e-2 + 1e-3
    ws = torch.rand(n, generator=g, device="cuda") * 1e-2 + 1e-3
    if form == "kernel":
        if k_major:
            wt = wq.t().contiguous()
            fn = lambda: fu.int8_mm(xq, wt, xs, ws, torch.float32,
                                    k_major=True)
        else:
            fn = lambda: fu.int8_mm(xq, wq, xs, ws, torch.float32)
    else:
        bias = (0.1 * torch.randn(n, generator=g, device="cuda")).bfloat16()
        lin = quant.QuantizedLinear(wq, ws[None, :], bias)
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        fn = lambda: lin(x)
    with torch.no_grad():
        out[name] = chip_smoke.time_ms(fn, iters=50)
print(json.dumps(out))
'''

# argv: the tree, this tree's stream cases (JSON: name, rows, K, N, bias,
# dtype)
STREAM_TURN = r'''
import importlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
dm = importlib.import_module("paddle_ray_tpu_torch.ops.decode_matmul")
out = {}
for name, b, k, n, with_bias, dtype in json.loads(sys.argv[2]):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(b + k + n)
    w_q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 2e-4 + 1e-5
    x = torch.randn(b, k, generator=g, device="cuda").to(dt)
    bias = (0.02 * torch.randn(n, generator=g, device="cuda")).to(dt) \
        if with_bias else None
    out[name] = chip_smoke.time_ms(
        lambda: dm.int8_stream_matmul(x, w_q, scale, bias), iters=50)
print(json.dumps(out))
'''


# argv: the tree, this tree's GroupNorm cases (JSON: name, N, rows, C,
# groups, act, modulated, dtype, calls a UNet step)
GN_TURN = r'''
import importlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
gn = importlib.import_module("paddle_ray_tpu_torch.ops.groupnorm")
t = chip_smoke.time_ms
out, step = {}, {"step_fwd": 0.0, "step_bwd": 0.0}
for name, n, rows, c, groups, act, mod, dtype, calls in json.loads(sys.argv[2]):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(n + rows + c)
    r = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    x = (1.5 * r(n, rows, c) + 0.5).to(dt)
    dy = r(n, rows, c).to(dt)
    w, b = (1.0 + 0.2 * r(c)).to(dt), (0.2 * r(c)).to(dt)
    s = (0.3 * r(n, c)).to(dt) if mod else None
    sh = (0.3 * r(n, c)).to(dt) if mod else None
    kw = dict(groups=groups, act=act)
    _, mu, rs = gn.fused_group_norm_fwd(x, w, b, s, sh, epsilon=1e-5, **kw)
    out[name] = {
        "fwd": t(lambda: gn.fused_group_norm_fwd(x, w, b, s, sh, epsilon=1e-5,
                                                 **kw), iters=50),
        "bwd": t(lambda: gn.fused_group_norm_bwd(x, w, b, s, sh, mu, rs, dy,
                                                 **kw), iters=50)}
    for kind in ("fwd", "bwd"):
        step[f"step_{kind}"] += calls * out[name][kind]
    del x, dy, mu, rs
print(json.dumps({**step, **out}))
'''


# argv: the tree
UNET_TURN = r'''
import contextlib, io, json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
log = io.StringIO()
with contextlib.redirect_stdout(log):
    chip_smoke.phase_device()
    chip_smoke.phase_unet_train()
rows = {r["phase"]: r for r in map(json.loads, filter(
    lambda l: l.startswith("{"), log.getvalue().splitlines()))}
train, prof = rows["unet_train"], rows["unet_profile"]
print(json.dumps({"step_ms": train["step_ms"],
                  "images_per_s": train["images_per_s"],
                  "profiled_device_ms": prof["device_ms"],
                  "device_idle_share": prof["device_idle_share"],
                  "group_norm_ms": prof["group_norm_ms"]}))
'''


# argv: the tree
SERVE_TURN = r'''
import contextlib, io, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from paddle_ray_tpu_torch.models import build_gpt
log = io.StringIO()
with contextlib.redirect_stdout(log):
    chip_smoke.phase_device()
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED)
    model = build_gpt(chip_smoke.MODEL, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    for _ in range(2):                  # the first run warms up
        chip_smoke.phase_serve(model)
rows = [r for r in map(json.loads, filter(
    lambda l: l.startswith("{"), log.getvalue().splitlines()))
    if r.get("phase") == "serve"]
print(json.dumps({k: rows[-1][k] for k in (
    "decode_tokens_per_s", "prefill_tokens_per_s", "p50_token_ms",
    "p99_token_ms", "mixed_steps", "wall_s")}))
'''

# the kernel libraries a kind's turns load, built in both trees at once
# before the first turn
PREBUILD = {"serve": ["paged_attention"]}

FLASH_HOST_CALLS = 500

# argv: the tree, calls of the host-time loop
TRAIN_TURN = r'''
import contextlib, importlib, io, json, sys, time, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
log = io.StringIO()
with contextlib.redirect_stdout(log):
    chip_smoke.phase_device()
    chip_smoke.phase_train()
    chip_smoke.phase_bert_train()
    chip_smoke.phase_encoder_train()
rows = {r["phase"]: r for r in map(json.loads, filter(
    lambda l: l.startswith("{"), log.getvalue().splitlines()))}
out = {}
for run, prof in (("train", "train_profile"), ("bert_train", "bert_profile"),
                  ("encoder_train", "encoder_profile")):
    out[run] = {"step_ms": rows[run]["step_ms"],
                "tokens_per_s": rows[run]["tokens_per_s"],
                "profiled_device_ms": rows[prof]["device_ms"],
                "device_idle_share": rows[prof]["device_idle_share"]}
fa = importlib.import_module("paddle_ray_tpu_torch.ops.flash_attention")
calls = int(sys.argv[2])
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(1, 128, 1, 64, device="cuda", generator=g,
                       dtype=torch.bfloat16).requires_grad_()
           for _ in range(3))
do = torch.randn(1, 128, 1, 64, device="cuda", generator=g,
                 dtype=torch.bfloat16)


def forward():
    with torch.no_grad():
        fa.flash_attention(q, k, v, causal=True)


def forward_backward():
    fa.flash_attention(q, k, v, causal=True).backward(do)


for name, fn in (("forward", forward), ("forward_backward",
                                        forward_backward)):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    out[f"flash_host_us_{name}"] = 1e6 * (time.perf_counter() - t0) / calls
print(json.dumps(out))
'''


def _flash_args() -> list:
    """This tree's bf16 flash cases and modes, and the rows the
    causal-segments mode leaves no visible key."""
    import torch
    import chip_smoke
    cases = [[name, b, s, h, hkv, d, causal, None]
             for name, b, s, h, hkv, d, dtype, causal in chip_smoke.FLASH_CASES
             if dtype == torch.bfloat16]
    b, s, h = chip_smoke.ENC_BATCH, chip_smoke.ENC_SEQ, chip_smoke.ENC_HEADS
    for mode in chip_smoke.FLASH_MODES:
        cases.append([mode, b, s, h, h, 64, mode.startswith("causal"),
                      mode[:-len("_bf16")]])
    return [json.dumps(cases), json.dumps(list(chip_smoke.LONELY_ROWS))]


def _paged_args() -> list:
    """This tree's paged cases, the dtype by name."""
    import chip_smoke
    return [json.dumps([[name, dict(kw, dtype=str(kw["dtype"]).split(".")[-1])]
                        for name, kw in chip_smoke.paged_cases()])]


def _dal_args() -> list:
    import chip_smoke
    return [json.dumps(chip_smoke.DAL_CASES)]


def _decode_args() -> list:
    import chip_smoke
    return [json.dumps(chip_smoke.DEC_ATTN_CASES)]


def _int8mm_args() -> list:
    import chip_smoke
    m = chip_smoke.ENC_BATCH * chip_smoke.ENC_SEQ
    cases = [[lin, m, k, n, "kernel"] for lin, k, n in chip_smoke.ENC_LINEARS]
    cases.append(["fc1_8192", 8192, 1024, 4096, "kernel"])
    cases += [[f"{lin}_quantized_linear", m, k, n, "layer"]
              for lin, k, n in chip_smoke.ENC_LINEARS]
    return [json.dumps(cases)]


def _stream_args() -> list:
    import chip_smoke
    return [json.dumps([[name, b, k, n, bias, str(dt).split(".")[-1]]
                        for name, b, k, n, bias, dt
                        in chip_smoke.matmul_cases()])]


def _gn_args() -> list:
    """The UNet step's bf16 (rows, C, mode) cases with their calls a step,
    then ``chip_smoke.GN_EXTRA_CASES`` but the misaligned view (no calls
    in the step)."""
    import chip_smoke
    calls = chip_smoke.unet_gn_calls()
    n, groups = chip_smoke.UNET_BATCH, chip_smoke.UNET_CFG["groups"]
    cases = []
    for rows, c, mode in sorted(set(calls), key=lambda k: (-k[0], k[1], k[2])):
        act, mod = chip_smoke.GN_MODES[mode]
        cases.append([f"unet_{rows}x{c}_{mode}_bf16", n, rows, c, groups, act,
                      mod, "bfloat16", calls.count((rows, c, mode))])
    for name, n, rows, c, g, mode, dtype, misalign in \
            chip_smoke.GN_EXTRA_CASES:
        if not misalign:
            act, mod = chip_smoke.GN_MODES[mode]
            cases.append([name, n, rows, c, g, act, mod, dtype, 0])
    return [json.dumps(cases)]


KINDS = {"flash": (FLASH_TURN, _flash_args), "paged": (PAGED_TURN, _paged_args),
         "dal": (DAL_TURN, _dal_args), "decode": (DECODE_TURN, _decode_args),
         "int8mm": (INT8MM_TURN, _int8mm_args),
         "stream": (STREAM_TURN, _stream_args), "gn": (GN_TURN, _gn_args),
         "unet": (UNET_TURN, list), "serve": (SERVE_TURN, list),
         "train": (TRAIN_TURN, lambda: [str(FLASH_HOST_CALLS)])}


def main() -> None:
    if len(sys.argv) != 3 or sys.argv[1] not in KINDS:
        raise SystemExit("usage: python3 tools/torch_ab.py {flash,paged,"
                         "dal,decode,int8mm,stream,gn,unet,serve,train} "
                         "OTHER_TREE")
    turn, make_args = KINDS[sys.argv[1]]
    trees = {"other": os.path.abspath(sys.argv[2]), "this": ROOT}
    sys.path.insert(0, ROOT)
    args = make_args()
    names = PREBUILD.get(sys.argv[1])
    if names:
        builds = [subprocess.Popen(
            [sys.executable, "-c", "import sys; from paddle_ray_tpu_torch."
             "ops import _build; _build.build_all(sys.argv[1:])", *names],
            cwd=tree) for tree in trees.values()]
        if any(p.wait(timeout=900) for p in builds):
            raise SystemExit("prebuild failed")
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, "-c", turn, trees[name], *args],
                              cwd=trees[name], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode:
            raise SystemExit(f"{name} turn failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"kind": sys.argv[1], "tree": name, **row}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
