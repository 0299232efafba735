"""Build and load the hand-written CUDA kernels; count their launches.

All kernel sources in this directory compile into ONE shared library with
a plain C interface, called through ctypes (no PyTorch headers, so a cold
build takes seconds). The build runs at first use, never at import:
each `.cu` file goes to its own `nvcc -c`, all started together, then one
link. The library's name carries a hash of the sources and flags, and a
file lock guards the build directory, so concurrent processes build once.
A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
SOURCES = ("gemm_small_m.cu", "masked_attention.cu", "sample_epilogue.cu",
           "flash_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas=-v",
)

HEAD_DIMS = (64, 128)  # the head dims the attention kernels are built for

# (kernel, site) -> launches; each wrapper adds one per kernel launch. The
# site names the TPU kernel whose work the launch carries.
launch_counts: "collections.Counter[tuple[str, str]]" = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vx_gemm_small_m": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                        _I, _I, _I, _I, _F, _P, _P),
    "vx_gemm_small_m_prep": (_P, _I, _P, _P, _I, _I, _F, _I, _P, _P, _P),
    "vx_masked_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _F,
                            _P, _P, _P, _P, _P, _I, _P),
    "vx_sample_epilogue": (_P, _I, _P, _I, _I, _I, _I, _F, _I, _I, _I, _F,
                           _P, _P, _P, _I, _P),
    "vx_flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _P),
    "vx_flash_attention_fwd_smem": (_I,),
    "vx_flash_attention_bwd_smem": (_I, _I),
    "vx_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "vx_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first"
            " use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvallex_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet) → .so path.
    The compiler's register/shared-memory report lands beside it as
    `ptxas_<hash>.txt`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        nvcc = _nvcc()
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            procs = []
            for name in SOURCES:
                obj = work / (name + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / name),
                       "-o", str(obj)]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )))
            report, failed = [], []
            for name, _, p in procs:
                out, _ = p.communicate()
                report.append(f"== {name}\n{out}")
                if p.returncode != 0:
                    failed.append(f"{name} (rc {p.returncode}):\n{out}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            tmp = work / lib.name
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp),
                 *(str(obj) for _, obj, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + link.stdout)
            (BUILD_DIR / f"ptxas_{_digest()}.txt").write_text(
                "\n".join(report)
            )
            os.replace(tmp, lib)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
