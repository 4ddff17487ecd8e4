"""Builds the port's CUDA kernels into one shared library at first use.

Every ``csrc/*.cu`` under :mod:`repro_torch.kernels` is compiled by its
own ``nvcc`` process (all started together) for ``sm_90a`` and linked
into ``build/librepro_torch_kernels_<hash>.so`` at the repository root.
The hash covers every file under each ``csrc/`` (headers too) and the
flags, so an edited kernel or header rebuilds and an unchanged one is
loaded as built.  ``-Xptxas=-v`` makes each compile report its kernels'
registers, shared memory and spills; :data:`build_log` keeps that
report from the last build.  The library exports plain C
functions and is bound with ``ctypes`` (no PyTorch headers, so a build
takes seconds).

Nothing here runs at import: :func:`library` builds on its first call,
which only a wrapper given a CUDA tensor makes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes; each returns cudaGetLastError()
SIGNATURES = {
    # x, w, col_mask, row_mask, y, workspace, C, M, K, N, bf16, trans_b,
    # bm, bn, splits, per, vec, stream
    "bmm_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _P],
    # q, k, v, o, BH, Sq, Skv, hd, causal, window, bf16, kernel, vec, stream
    "flash_attn_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # tensors, n_tensors, desc, members, items, groups, items2, partial,
    # out, stream
    "group_l2_fwd_launch": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    # tensors, grads, n_tensors, desc, members, items, g, stream
    "group_l2_bwd_launch": [_P, _P, _I, _P, _I, _I, _P, _P],
    # a, b, h, B, S, W, bf16, kernel, stream
    "rglru_scan_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: Optional[str] = None     # nvcc's output of the last build
builds = 0                          # builds that ran nvcc in this process


def sources():
    """The translation units: every ``csrc/*.cu``."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def csrc_files(kernels_dir: Path = KERNELS_DIR):
    """Every file under each ``csrc/``: the sources and what they
    include."""
    return sorted(p for p in kernels_dir.glob("*/csrc/**/*") if p.is_file())


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set $NVCC or put it on "
                       "PATH)")


def library_path(kernels_dir: Path = KERNELS_DIR,
                 flags=tuple(NVCC_FLAGS)) -> Path:
    """The library's path, keyed by the flags (include paths and link
    libraries among them) and every file under each ``csrc/``."""
    h = hashlib.sha256("\0".join(flags).encode())
    for f in csrc_files(kernels_dir):
        h.update(str(f.relative_to(kernels_dir)).encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library if it is not built yet; return its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    global build_seconds, build_log, builds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors, logs = [], []
        for src, p in procs:
            log, _ = p.communicate()
            logs.append(f"{src.name}:\n{log}")
            if p.returncode != 0:
                errors.append(logs[-1])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)           # atomic: no half-written .so
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    builds += 1
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device`` (a CUDA device with an
    index), as the C entry points take it: PyTorch's raw-stream query, a
    microsecond where ``torch.cuda.current_stream`` builds a Stream
    object (~5 us a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
