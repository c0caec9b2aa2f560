"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source (`<kernel>/<name>.cu`, plain C interface, no PyTorch
headers) compiles with one `nvcc` into its own shared library under
`build/kernels/` at the repository root, named by a digest of its
sources and flags so an edited kernel never loads a stale build.
`build()` starts one `nvcc` per missing library, all at once, and waits
for them; `library()` builds what it needs and loads it.  Nothing here
runs at import: a machine without `nvcc` imports every module and only
a CUDA launch needs the compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "kernels"
SOURCES = {
    "flash": KERNEL_DIR / "flash_attention" / "flash.cu",
    "flash_bwd": KERNEL_DIR / "flash_attention" / "flash_bwd.cu",
    "selective": KERNEL_DIR / "selective_attention" / "selective.cu",
    "paged_decode": KERNEL_DIR / "paged_attention" / "paged_decode.cu",
    "block_gather": KERNEL_DIR / "block_gather" / "gather.cu",
    "embedding_bag": KERNEL_DIR / "embedding_bag" / "bag.cu",
}
HEADERS = (KERNEL_DIR / "attn_common.cuh", KERNEL_DIR / "attn_small.cuh",
           KERNEL_DIR / "attn_tile.cuh")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in (SOURCES[name], *HEADERS):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library among `names` (default: all) in
    parallel.  -> wall seconds spent.  Each build's compiler output
    (register and spill report) is kept beside the library as `.log`."""
    t0 = time.perf_counter()
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(KERNEL_DIR), "-o", str(tmp),
               str(SOURCES[n])]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for kernel `name` (built first if missing),
    with `argtypes` set from `signatures` and every function returning
    the launch's `cudaError_t` as an int."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
