"""Build a kernel's CUDA source with ``nvcc`` into a shared library with a
plain C interface, and load it with ``ctypes``.

Each kernel package calls ``build`` at its first CUDA launch (never at
import: the CPU tests import every module). The library lands in
``<repo>/build/<name>/`` under a name keyed on the hash of the source and
of the shared headers in ``kernels/csrc`` (on the include path), so an
edited source or header builds anew and an unchanged one is reused;
ptxas's register, shared-memory and spill report is kept beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is not None:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str, src: Path) -> tuple[Path, str]:
    """Compile ``src`` (once per version of it and the shared headers) into
    ``build/<name>/lib<name>-<hash>.so``; returns its path and ptxas's
    report. Raises with nvcc's output when the compile fails."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_ROOT / name / f"lib{name}-{digest.hexdigest()[:12]}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return out, log_path.read_text()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.partial")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    log_path.write_text(res.stdout + res.stderr)
    return out, res.stdout + res.stderr


def load(name: str, src: Path) -> ctypes.CDLL:
    """``build`` then ``ctypes.CDLL``; the caller declares argtypes."""
    path, _ = build(name, src)
    return ctypes.CDLL(str(path))
