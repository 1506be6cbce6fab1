"""Build the port's CUDA sources with plain nvcc and load them with ctypes.

Each source in `csrc/` has a plain C interface, so it compiles in seconds
without PyTorch's headers, ninja or `torch.utils.cpp_extension`. The shared
library goes into `build/kernels/` at the repository root (git-ignored),
named by a hash of the source, the headers in `csrc/` and the flags, and is
built at first use. The libraries link libcuda (`-lcuda`, from the
toolkit's stubs at build time): K1's bf16 kernels encode their TMA tensor
maps on the host with `cuTensorMapEncodeTiled`, which libcuda exports.

Host C++ sources (`csrc/*.cpp`, such as the JPEG codec of the data path)
take the same route with `g++` instead of nvcc (`load_host`); a missing or
failing compiler raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda",
)

HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()
_entries: dict[tuple, object] = {}
build_logs: dict[str, str] = {}  # nvcc's stderr (ptxas register report)
build_seconds: dict[str, float] = {}  # wall time of each source's nvcc or g++


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
    """The source and its library's path, named by a hash of the source,
    every header in csrc/ (any of them may be included) and the flags."""
    src = CSRC / f"{name}.cu"
    blob = src.read_bytes() + b"".join(
        h.name.encode() + h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> dict[str, Path]:
    """Compile `csrc/<name>.cu` for every name not built yet, one nvcc
    process per source, all started together; each one's wall time goes
    into `build_seconds` and its stderr into `build_logs`."""
    jobs, outs = {}, {}
    for name in names:
        src, out = _target(name)
        outs[name] = out
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        with open(log, "w") as err:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=subprocess.DEVNULL, stderr=err)
        jobs[name] = (proc, src, tmp, out, log, time.perf_counter())
    failed = []
    while jobs:
        for name in [n for n, job in jobs.items() if job[0].poll() is not None]:
            proc, src, tmp, out, log, t0 = jobs.pop(name)
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = log.read_text()
            log.unlink()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{build_logs[name]}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        time.sleep(0.05)
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


def raw_stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, as the entry points
    take it, without building a torch.cuda.Stream (which costs about 10 us
    of host time a launch on the H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def load_host(name: str) -> ctypes.CDLL:
    """The shared library of the host source `csrc/<name>.cpp`, compiled at
    first use by g++ into `build/kernels/` and loaded; thread-safe. The
    file is named by a hash of the source, the flags, the compiler's
    version and target, the machine and its C library, so a library built
    on another machine is never loaded. Raises RuntimeError when g++ is
    missing or fails."""
    with _host_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cpp"
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: it builds {src}")
        toolchain = [subprocess.run([gxx, flag], capture_output=True, text=True).stdout
                     for flag in ("-dumpfullversion", "-dumpmachine")]
        key = [src.read_bytes().decode(), *HOST_FLAGS, *toolchain, platform.machine(),
               *platform.libc_ver()]
        digest = hashlib.sha1("\0".join(key).encode()).hexdigest()[:12]
        out = BUILD_DIR / f"{name}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic, as for nvcc
        lib = _loaded[name] = ctypes.CDLL(str(out))
        return lib
