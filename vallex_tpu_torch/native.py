"""ctypes bindings for the native host runtime (native/vallex_native.cpp):
`tokenize` (phoneme string → ids), `load_wav` (RIFF/WAVE → mono f32 at the
file's rate) and `resample` (windowed-sinc), with the signatures of
vallex_tpu/native.py. The frontend tokenizer and `utils.audio.load_wav`
go through them.

The library builds at first use, never at import: `g++ -O3 -std=c++17
-shared -fPIC` into native/_build/, under a name that carries a hash of
the source and the flags. A file lock guards the build directory, so
processes that start together (serving workers, training ranks) build
once. A failed build or load raises with the compiler's message; nothing
falls back to the Python versions, which stay as plain versions for the
tests (`frontend.tokenizer.lookup_ids`, `utils.audio.read_wav_plain`,
`utils.audio.resample_plain`).
"""

from __future__ import annotations

import ctypes
import errno
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "native"
SOURCE = SRC_DIR / "vallex_native.cpp"
BUILD_DIR = SRC_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# vn_load_wav's error codes (vallex_native.cpp)
WAV_ERRORS = {
    -2: "not a RIFF/WAVE file, or no fmt or data chunk",
    -3: "its data chunk runs past the end of the file",
    -4: "a sample format other than 8/16/24/32-bit PCM or 32-bit float",
}

_lib = None
_lib_lock = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {  # name: (argtypes, restype)
    "vn_set_vocab": ((ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
                      ctypes.c_int, ctypes.c_int32), None),
    "vn_tokenize": ((ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int),
                    ctypes.c_int),
    "vn_load_wav": ((ctypes.c_char_p, _F32P, ctypes.c_long, ctypes.POINTER(ctypes.c_int32)),
                    ctypes.c_long),
    "vn_resample": ((_F32P, ctypes.c_long, ctypes.c_int32, ctypes.c_int32, _F32P,
                     ctypes.c_long), ctypes.c_long),
}


def _digest() -> str:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvallex_native_{_digest()}.so"


def build() -> Path:
    """Compile the library (if this source hash is not built yet) → .so path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(f"{CXX} not found: the native host runtime is built from"
                               f" {SOURCE} at first use and needs a C++ compiler on PATH")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{CXX} failed (rc {out.returncode}) building {SOURCE}:\n"
                                   + out.stdout)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library with the frontend's vocab installed, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the native host runtime {path}: {e}") from e
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            from .frontend.symbols import UNK_ID, char_to_id

            pairs = [(ord(ch), i) for ch, i in char_to_id.items() if len(ch) == 1]
            n = len(pairs)  # the [UNK] / [CLS] / ... specials stay out
            lib.vn_set_vocab((ctypes.c_uint32 * n)(*(c for c, _ in pairs)),
                             (ctypes.c_int32 * n)(*(i for _, i in pairs)), n, UNK_ID)
            _lib = lib
        return _lib


def tokenize(phonemes: str) -> np.ndarray:
    """Char-level encode: one int32 id a character, [UNK]'s for unknown ones."""
    if "\0" in phonemes:
        raise ValueError("tokenize: a phoneme string holds no NUL character")
    out = np.zeros(len(phonemes) + 1, np.int32)
    n = library().vn_tokenize(phonemes.encode("utf-8"),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(out))
    return out[:n]


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (mono float32 samples, the file's sample rate). Raises
    FileNotFoundError for a file that cannot be opened, ValueError naming
    the path for one the decoder rejects."""
    lib, raw = library(), os.fsencode(path)
    sr = ctypes.c_int32()
    n = lib.vn_load_wav(raw, None, 0, ctypes.byref(sr))
    if n >= 0:
        buf = np.zeros(n, np.float32)
        n = lib.vn_load_wav(raw, buf.ctypes.data_as(_F32P), n, ctypes.byref(sr))
    if n == -1:
        raise FileNotFoundError(errno.ENOENT, "cannot open the WAV file", str(path))
    if n < 0:
        raise ValueError(f"{path}: {WAV_ERRORS[n]}")
    return buf[:n], int(sr.value)


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Mono float32 samples at sr_in → at sr_out (len · up // down samples)."""
    wav = np.ascontiguousarray(wav, np.float32)
    if wav.ndim != 1 or sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"resample: mono samples and positive rates, got {wav.shape},"
                         f" {sr_in} -> {sr_out}")
    lib, src = library(), wav.ctypes.data_as(_F32P)
    out = np.zeros(lib.vn_resample(src, len(wav), sr_in, sr_out, None, 0), np.float32)
    n = lib.vn_resample(src, len(wav), sr_in, sr_out, out.ctypes.data_as(_F32P), len(out))
    return out[:n]
