"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``fks_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at the repository root
the first time it is needed, then loaded with ``ctypes``. The hash covers
the source, the headers of ``csrc/`` it may include and the flags, so an
edited kernel or header rebuilds and a built one is reused. ``nvcc`` runs only here, inside a call — never when a module is
imported — so the CPU tests import every module without a toolkit.

Flags: no fast math and ``--fmad=false``, so float arithmetic stays IEEE
round-to-nearest as the kernels' bit-exactness contract needs;
``-Xptxas -v`` writes the register and shared-memory report next to the
library (``<name>-<hash>.ptxas.txt``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build from source on first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; returns
    the library path. Raises with nvcc's output when compilation fails."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output (registers, shared memory, spills)."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """The built library, loaded once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def fused_sim_library() -> ctypes.CDLL:
    """``csrc/fused_sim.cu`` with its C signatures declared."""
    lib = load("fused_sim")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fks_fused_sim.argtypes = [p] * 14 + [i] * 8 + [ll] * 4 + [p]
    lib.fks_fused_sim.restype = ctypes.c_int
    lib.fks_fused_sim_smem_bytes.argtypes = [i] * 4
    lib.fks_fused_sim_smem_bytes.restype = ctypes.c_size_t
    lib.fks_cuda_error_string.argtypes = [i]
    lib.fks_cuda_error_string.restype = ctypes.c_char_p
    return lib


def param_score_library() -> ctypes.CDLL:
    """``csrc/param_score.cu`` with its C signatures declared."""
    lib = load("param_score")
    lib.fks_param_score.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.fks_param_score.restype = ctypes.c_int
    lib.fks_param_score_floor.argtypes = lib.fks_param_score.argtypes
    lib.fks_param_score_floor.restype = ctypes.c_int
    lib.fks_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fks_cuda_error_string.restype = ctypes.c_char_p
    return lib
