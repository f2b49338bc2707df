"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``ops/csrc/<name>.cu`` exposes a plain C entry point (no PyTorch
headers), so one ``nvcc`` call builds it in seconds.  The shared object
lands in ``paddle_ray_tpu_torch/_build/`` (git-ignored), named by a hash
of the source and the flags, at first use; later calls in the process
reuse the loaded library.  A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

__all__ = ["NVCC_FLAGS", "build", "build_all", "csrc_path", "load", "nvcc"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def csrc_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built from source")


def _target(name: str) -> str:
    with open(csrc_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


class _Job:
    """One running ``nvcc``: it writes to a temporary name, renamed to the
    target when the build succeeds."""

    def __init__(self, name: str, target: str):
        os.makedirs(_BUILD, exist_ok=True)
        fd, self.tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        self.name, self.target = name, target
        self.proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", self.tmp, csrc_path(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> str:
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            os.unlink(self.tmp)
            raise RuntimeError(f"nvcc failed for {self.name}.cu "
                               f"(exit {self.proc.returncode}):\n{log}")
        os.replace(self.tmp, self.target)
        return log

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _start(name: str) -> Optional[_Job]:
    """Start ``nvcc`` for one source unless its library is already built."""
    target = _target(name)
    return None if os.path.exists(target) else _Job(name, target)


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Build several sources at once (one ``nvcc`` each, all started
    together).  Returns ``{name: compiler output}``; '' for a library
    that was already built."""
    jobs = {n: _start(n) for n in names}
    logs = {}
    try:
        for n, job in jobs.items():
            logs[n] = "" if job is None else job.finish()
    finally:
        for job in jobs.values():
            if job is not None:
                job.kill()
    return logs


def build(name: str) -> str:
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(_target(name))
        _LOADED[name] = lib
    return lib
