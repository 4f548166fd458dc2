"""Build and load the port's CUDA kernels.

Each source under ``ntxent_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C entry point,
which the kernel's wrapper loads with ``ctypes``. Sources include no
PyTorch header, so a build takes seconds. Libraries go to
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of their source, and are built on first
use: a fresh checkout builds what it runs. A source may include the
headers beside it (``csrc/*.cuh``); their bytes enter every hash.
``build()`` starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build", "load", "nvcc_command"]

_PACKAGE = Path(__file__).resolve().parents[1]
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
SOURCES: dict[str, Path] = {
    "flash_attention_fwd": _PACKAGE / "csrc" / "flash_attention_fwd.cu",
    "flash_attention_bwd": _PACKAGE / "csrc" / "flash_attention_bwd.cu",
    "ntxent_fwd": _PACKAGE / "csrc" / "ntxent_fwd.cu",
    "ntxent_bwd_sym": _PACKAGE / "csrc" / "ntxent_bwd_sym.cu",
    "ntxent_bwd_general": _PACKAGE / "csrc" / "ntxent_bwd_general.cu",
    "infonce_dual_fwd": _PACKAGE / "csrc" / "infonce_dual_fwd.cu",
    "infonce_dual_bwd": _PACKAGE / "csrc" / "infonce_dual_bwd.cu",
    "infonce_bwd_cols": _PACKAGE / "csrc" / "infonce_bwd_cols.cu",
}
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in (
            os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
            shutil.which("nvcc"),
            "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> Path:
    """The library of ``name``, named by a hash of its source and of the
    headers beside it (``csrc/*.cuh``), which a source may include."""
    digest = hashlib.sha1(SOURCES[name].read_bytes())
    for header in sorted((_PACKAGE / "csrc").glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The compile line of one kernel library (``-Xptxas -v`` reports
    registers, shared memory and spills on stderr)."""
    return [nvcc, *_ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(SOURCES[name])]


def build(names=None) -> dict[str, str]:
    """Compile every named library that is not built yet, in parallel.

    Returns ``{name: nvcc's stderr}`` for what it compiled (the ptxas
    report) and raises ``RuntimeError`` with the compiler's output when
    a build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(name, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        logs[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
