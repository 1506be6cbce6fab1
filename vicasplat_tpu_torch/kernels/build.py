"""Build the port's CUDA sources with plain nvcc and load them with ctypes.

Each source in `csrc/` has a plain C interface, so it compiles in seconds
without PyTorch's headers, ninja or `torch.utils.cpp_extension`. The shared
library goes into `build/kernels/` at the repository root (git-ignored),
named by a hash of the source and the flags, and is built at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple, object] = {}
build_logs: dict[str, str] = {}  # nvcc's stderr (ptxas register report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> dict[str, Path]:
    """Compile `csrc/<name>.cu` for every name not built yet, one nvcc
    process per source, all started together."""
    jobs, outs = {}, {}
    for name in names:
        src, out = _target(name)
        outs[name] = out
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs[name] = (proc, src, tmp, out)
    failed = []
    for name, (proc, src, tmp, out) in jobs.items():
        _, err = proc.communicate()
        build_logs[name] = err
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` into a shared library unless it is built."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of `csrc/<name>.cu`, with its argument
    types and its int (cudaError_t) result type set once, when it is first
    asked for."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn
