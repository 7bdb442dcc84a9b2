"""ctypes bindings for the port's host corpus packers (``pack.cpp``).

``pack_lines`` splits a newline-delimited buffer into a padded batch and
``tile_corpus`` packs a batch into the tiled input contract's quad words;
both are multithreaded C++ (OpenMP), copied from the JAX package's
``native/scan.cpp``.  The library is built with g++ at first use under the
port's build root (``ops.kernels.build_root()``, keyed by a hash of the
source and flags), never inside the package.

``available()`` is False only where no g++ exists; callers then take the
numpy versions (``utils.io.pack_lines``, ``ops.bitplane.tile_corpus``).
Where g++ exists, a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "pack.cpp"
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
LANE = 128


def available() -> bool:
    """Whether the packers can be built here (a g++ on PATH)."""
    return shutil.which("g++") is not None


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..ops.kernels import build_root

    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = build_root() / "native" / key / "libh2rpack.so"
    with _LOCK:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"libh2rpack.{os.getpid()}.{threading.get_ident()}.so")
            cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({res.returncode}) building {so}:\n{' '.join(cmd)}\n{res.stderr}"
                )
            os.replace(tmp, so)  # atomic: a reader never sees a partial library
    lib = ctypes.CDLL(str(so))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.h2r_pack_lines.argtypes = [u8p, i64, i64, i32, u8p, i32p, ctypes.POINTER(i64), i32]
    lib.h2r_pack_lines.restype = i64
    lib.h2r_tile_corpus.argtypes = [u8p, i64, i64, i64, i64, i32p]
    lib.h2r_tile_corpus.restype = None
    lib.h2r_num_threads.restype = ctypes.c_int
    return lib


def num_threads() -> int:
    return _lib().h2r_num_threads()


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pack_lines(data: bytes, max_len: int,
               keep_newline: bool = False) -> Tuple[np.ndarray, np.ndarray, int]:
    """Split a newline-delimited buffer into (chars [N, max_len] uint8,
    lengths [N] int32, n_truncated); ``keep_newline`` restores each
    terminated line's ``\\n`` byte."""
    lib = _lib()
    nl = 1 if keep_newline else 0
    buf = np.frombuffer(data, np.uint8)
    n = lib.h2r_pack_lines(_u8p(buf), buf.size, max_len, 1, None, None, None, nl)
    # np.empty: the fill pass writes every byte of every row
    chars = np.empty((n, max_len), np.uint8)
    lengths = np.empty((n,), np.int32)
    trunc = ctypes.c_int64(0)
    lib.h2r_pack_lines(_u8p(buf), buf.size, max_len, 0, _u8p(chars), _i32p(lengths),
                       ctypes.byref(trunc), nl)
    return chars, lengths, int(trunc.value)


def tile_corpus(chars: np.ndarray, L_pad: int) -> np.ndarray:
    """[B, L] uint8 -> [NWS, 8, L_pad, 128] int32 quad words (the layout
    of ``ops.bitplane.tile_corpus``); B is padded up to a multiple of 4096
    and L up to L_pad with zero bytes."""
    chars = np.ascontiguousarray(chars, np.uint8)
    B, L = chars.shape
    if L > L_pad:
        raise ValueError(f"chars are [B, {L}]: longer than L_pad={L_pad}")
    nws = -(-B // (32 * LANE))
    out = np.empty((nws, 8, L_pad, LANE), np.int32)
    _lib().h2r_tile_corpus(_u8p(chars), B, L, L_pad, nws, _i32p(out))
    return out
