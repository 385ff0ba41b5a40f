"""Build the port's CUDA sources into shared libraries, at first use.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``build/nerfmlp_torch/`` beside
the package (or ``$NERFMLP_TORCH_BUILD_DIR``) and loaded with ``ctypes``.
The library's file name carries a hash of its source and flags, so an
edited source rebuilds and an unchanged one loads at once. Builds write
to a temporary name and rename, so concurrent processes never load a
half-written library. No ``--use_fast_math``: the encoding's ``sinf``/
``cosf`` take arguments of several thousand, where the fast intrinsics
are wrong.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")

# Every kernel of the port: library name -> its source in csrc/.
KERNELS = {"fused_mlp_fwd": "fused_mlp_fwd.cu",
           "fused_mlp_bwd": "fused_mlp_bwd.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, into the log
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}   # by library path


def build_dir() -> str:
    default = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                           "nerfmlp_torch")
    return os.environ.get("NERFMLP_TORCH_BUILD_DIR", default)


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name: str, csrc: str = CSRC) -> str:
    """Where ``name``'s library lives for its source in ``csrc`` and the
    flags."""
    with open(os.path.join(csrc, KERNELS[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(KERNELS),
          csrc: str = CSRC) -> Dict[str, str]:
    """Compile every named kernel of ``csrc`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns name -> library
    path; raises with the compiler's output when a build fails. The
    compiler's log (``-Xptxas -v``) is kept beside each library as
    ``<lib>.log``."""
    os.makedirs(build_dir(), exist_ok=True)
    paths = {n: library_path(n, csrc) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(csrc, KERNELS[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        with open(paths[name] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{KERNELS[name]}:\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str, csrc: str = CSRC) -> ctypes.CDLL:
    """The kernel library ``name`` of the sources in ``csrc``, built if
    needed; loaded once."""
    with _lock:
        path = build([name], csrc)[name]
        if path not in _loaded:
            _loaded[path] = ctypes.CDLL(path)
        return _loaded[path]
