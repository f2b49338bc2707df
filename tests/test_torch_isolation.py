"""The port stands alone: ``paddle_ray_tpu_torch``, ``chip_smoke.py`` and
the port's tools (every ``tools/torch_*.py``) import neither JAX nor
anything of the JAX package, import ``triton`` nowhere at module level,
import without JAX installed, and run on the CPU only when asked to by
name."""
import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_ray_tpu_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    out += glob.glob(os.path.join(REPO, "tools", "torch_*.py"))
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree, module_level_only=False):
    """Absolute module names imported in ``tree`` (optionally only by
    statements outside any function body)."""
    names = []
    stack = list(tree.body) if module_level_only else [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        if module_level_only and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return names


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_ray_tpu")


def test_sources_import_no_jax_and_no_jax_package():
    sources = _sources()
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad = [n for n in _imports(tree) if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_triton_is_never_imported_at_module_level():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad = [n for n in _imports(tree, module_level_only=True)
               if n.split(".")[0] == "triton"]
        assert not bad, f"{os.path.relpath(path, REPO)} imports triton"


def test_tools_are_found_by_glob():
    tools = {os.path.basename(p) for p in _sources()
             if os.path.dirname(p) == os.path.join(REPO, "tools")}
    assert "torch_serve_profile.py" in tools


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import paddle_ray_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'paddle_ray_tpu' or k.startswith("
        "'paddle_ray_tpu.') for k in sys.modules)\n"
        "print(' '.join(sorted(names)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = set(proc.stdout.split())
    for mod in ("core.prng", "ops.decode_attention", "ops.decode_matmul",
                "quantization.quant", "models.generation",
                "serving.engine", "ops.groupnorm", "models.unet",
                "nn.init", "ops.fused", "models.bert", "incubate.nn",
                "ops", "quantization", "weights", "checkpoint.manager",
                "checkpoint.sharded", "train.chaos", "train.loop"):
        assert f"paddle_ray_tpu_torch.{mod}" in imported, mod


def test_cuda_is_the_default_device(monkeypatch):
    from paddle_ray_tpu_torch import default_device
    from paddle_ray_tpu_torch.models import build_gpt, gpt_loss_fn
    from paddle_ray_tpu_torch.optimizer import AdamW
    from paddle_ray_tpu_torch.parallel import build_train_step
    from paddle_ray_tpu_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(num_layers=1, hidden_size=32, num_heads=4, vocab_size=64,
                 max_seq_len=32)
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        build_gpt("gpt3-125m", **small)
    model = build_gpt("gpt3-125m", device="cpu", **small)
    with pytest.raises(RuntimeError):
        ServingEngine(model, page_size=8, max_batch=1)
    eng = ServingEngine(model, page_size=8, max_batch=1, device="cpu")
    rid = eng.submit(np.arange(5), 3)
    assert len(eng.run()[rid]) == 3
    # training: a model needs device="cpu" here; the step then runs there
    with pytest.raises(RuntimeError):
        build_gpt("gpt3-125m", attn_impl="flash", **small)
    ts = build_train_step(build_gpt("gpt3-125m", device="cpu",
                                    attn_impl="flash", **small),
                          AdamW(1e-3), gpt_loss_fn)
    ids = torch.arange(16).reshape(2, 8)
    assert ts.step((ids, ids)).device.type == "cpu"
    # decoding runs where the model lives: the CPU only when built there
    from paddle_ray_tpu_torch.models import generate, quantize_for_decode
    out = generate(quantize_for_decode(model), ids, 3,
                   kv_cache_dtype="int8")
    assert out.shape == (2, 11) and out.device.type == "cpu"


def test_chip_smoke_fails_without_cuda():
    """Without a card the script exits non-zero before printing any
    result line."""
    code = ("import torch, runpy, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
