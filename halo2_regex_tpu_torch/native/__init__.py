"""ctypes bindings for the port's native host code: the corpus packers
(``pack.cpp``), the host oracle (``scan.cpp``) and the standalone prover
hand-off verifier (``handoff_check.cpp``).

``pack_lines`` splits a newline-delimited buffer into a padded batch and
``tile_corpus`` packs a batch into the tiled input contract's quad words.
``scan_states``, ``substr_scan`` and ``mask_fsm`` are the per-def DFA
scan, the substring tagging and the mask FSMs on the model's dense tables,
and ``match_substrs_native`` combines them into the witness columns of a
whole batch (``native_result``: the whole ``RegexResult``): a conformance
oracle (chip_smoke holds the card's outputs to it), never a path of the
device.  All are multithreaded C++ (OpenMP),
copied from the JAX package's ``native/scan.cpp``.  One library is built
from both sources with g++ at first use under the port's build root
(``ops.kernels.build_root()``, keyed by a hash of the sources and flags),
never inside the package.  ``handoff_check`` runs the hand-off verifier,
a program of its own that reads a ``witness.handoff`` dump and depends on
nothing of the package, built with g++ at first use beside that library.

``available()`` is False only where no g++ exists; callers then take the
numpy packers (``utils.io.pack_lines``, ``ops.bitplane.tile_corpus``) and
the numpy oracle (``ops.reference``).  Where g++ exists, a failed build
raises with the compiler's output.
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

_SRCS = tuple(Path(__file__).resolve().parent / f for f in ("pack.cpp", "scan.cpp"))
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
LANE = 128


def available() -> bool:
    """Whether the packers can be built here (a g++ on PATH)."""
    return shutil.which("g++") is not None


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..ops.kernels import build_root

    blob = b"".join(f.read_bytes() for f in _SRCS) + " ".join(_FLAGS).encode()
    key = hashlib.sha256(blob).hexdigest()[:16]
    so = build_root() / "native" / key / "libh2rnative.so"
    with _LOCK:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"libh2rnative.{os.getpid()}.{threading.get_ident()}.so")
            cmd = ["g++", *_FLAGS, *map(str, _SRCS), "-o", str(tmp)]
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
    lib.h2r_scan_states.argtypes = [u8p, i32p, i64, i64, i32p, i32, i32, i32, i32p]
    lib.h2r_scan_states.restype = None
    lib.h2r_substr_scan.argtypes = [i32p, i32p, i64, i64, i32p, i32, u8p, u8p, i64, i32p, i32p,
                                    i32p]
    lib.h2r_substr_scan.restype = None
    lib.h2r_mask_fsm.argtypes = [i32p, i32p, i32p, i64, i64, i32p, i32p, i32p]
    lib.h2r_mask_fsm.restype = None
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


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def scan_states(chars: np.ndarray, lengths: np.ndarray, transition: np.ndarray,
                first_state: int, dummy_state: int) -> np.ndarray:
    """Batched sequential DFA scan of one def: chars [B, L] uint8,
    transition [256, S] int32 -> states [B, L+1] int32, the real states
    in rows 0..len and ``dummy_state`` beyond (the oracle's padding)."""
    chars = np.ascontiguousarray(chars, np.uint8)
    lengths, transition = _i32(lengths), _i32(transition)
    B, L = chars.shape
    if lengths.shape != (B,) or transition.ndim != 2 or transition.shape[0] != 256:
        raise ValueError(f"lengths {lengths.shape}, transition {transition.shape}: expected "
                         f"({B},) and (256, S)")
    if B and (lengths.min() < 0 or lengths.max() > L):
        raise ValueError(f"lengths must lie in [0, {L}]")
    out = np.empty((B, L + 1), np.int32)
    _lib().h2r_scan_states(_u8p(chars), _i32p(lengths), B, L, _i32p(transition),
                           transition.shape[1], int(first_state), int(dummy_state), _i32p(out))
    return out


def substr_scan(states: np.ndarray, lengths: np.ndarray, substr_table: np.ndarray,
                is_start_table: np.ndarray,
                is_end_table: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Substring ids and start/end flags of one def: ``states`` [B, L+1]
    (``scan_states``'s) -> (ids [B, L], is_start [B, L+1], is_end [B, L+1]
    right-shifted), int32."""
    states, lengths, substr_table = _i32(states), _i32(lengths), _i32(substr_table)
    ist = np.ascontiguousarray(is_start_table, np.uint8)
    iet = np.ascontiguousarray(is_end_table, np.uint8)
    B, L = states.shape[0], states.shape[1] - 1
    S = substr_table.shape[1]
    if substr_table.shape != (S, S) or ist.shape[1] != S or iet.shape != ist.shape:
        raise ValueError(f"tables {substr_table.shape}, {ist.shape}, {iet.shape}: expected "
                         f"(S, S) and two (n_ids, S)")
    if lengths.shape != (B,) or (B and (lengths.min() < 0 or lengths.max() > L)):
        raise ValueError(f"lengths must be ({B},) in [0, {L}]")
    if B and L and (states.min() < 0 or states.max() >= S):
        raise ValueError(f"states must lie in [0, {S})")
    ids = np.empty((B, L), np.int32)
    iso = np.empty((B, L + 1), np.int32)
    ieo = np.empty((B, L + 1), np.int32)
    _lib().h2r_substr_scan(_i32p(states), _i32p(lengths), B, L, _i32p(substr_table), S,
                           _u8p(ist), _u8p(iet), ist.shape[0], _i32p(ids), _i32p(iso), _i32p(ieo))
    return ids, iso, ieo


def mask_fsm(id_sum: np.ndarray, is_start_sum: np.ndarray,
             is_end_sum: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The forward and backward mask FSMs on the summed columns: id_sum
    [B, L], the flag sums [B, L+1] -> (fwd, bwd, mask), each [B, L]
    int32."""
    id_sum, iss, ies = _i32(id_sum), _i32(is_start_sum), _i32(is_end_sum)
    B, L = id_sum.shape
    if iss.shape != (B, L + 1) or ies.shape != (B, L + 1):
        raise ValueError(f"flag sums {iss.shape}, {ies.shape}: expected {(B, L + 1)}")
    fwd, bwd, msk = (np.empty((B, L), np.int32) for _ in range(3))
    _lib().h2r_mask_fsm(_i32p(id_sum), _i32p(iss), _i32p(ies), B, L, _i32p(fwd), _i32p(bwd),
                        _i32p(msk))
    return fwd, bwd, msk


def _native_passes(model, chars: np.ndarray, lengths: np.ndarray):
    """The per-def native passes of a whole batch: the columns of
    ``match_substrs_native`` and, per def, the start flags [B, L+1] and
    the right-shifted end flags [B, L+1] of ``substr_scan``."""
    chars = np.ascontiguousarray(chars, np.uint8)
    lengths = _i32(lengths)
    B, L = chars.shape
    n_defs = model.n_defs
    id_sum = np.zeros((B, L), np.int32)
    iss_sum = np.zeros((B, L + 1), np.int32)
    ies_sum = np.zeros((B, L + 1), np.int32)
    accepted = np.zeros((B, n_defs), bool)
    has_dead = np.zeros((B, n_defs), bool)
    states_all, ids_all, starts, ends = [], [], [], []
    for d in range(n_defs):
        raw = scan_states(chars, lengths, model.transition[d], int(model.first_states[d]),
                          int(model.dummy_states[d]))
        # rows past the length carry the dummy already; rows 0..len are real
        final = raw[np.arange(B), lengths]
        accepted[:, d] = final == int(model.accepted_states[d])
        has_dead[:, d] = final == int(model.dead_states[d])
        ids, iso, ieo = substr_scan(raw, lengths, model.substr_id_table[d],
                                    model.is_start_table, model.is_end_table)
        id_sum += ids
        iss_sum += iso
        ies_sum += ieo
        states_all.append(raw)
        ids_all.append(ids)
        starts.append(iso)
        ends.append(ieo)
    fwd, bwd, msk = mask_fsm(id_sum, iss_sum, ies_sum)
    enable = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    chars_i32 = chars.astype(np.int32) * enable
    cols = dict(
        all_enable_flags=enable,
        all_characters=chars_i32,
        all_substr_ids=msk * id_sum,
        masked_characters=msk * chars_i32,
        states=np.stack(states_all, 1),
        substr_ids_per_def=np.stack(ids_all, 1),
        substr_id_sum=id_sum,
        is_start_sum=iss_sum,
        is_end_sum=ies_sum,
        fwd_mask=fwd,
        bwd_mask=bwd,
        mask=msk,
        accepted=accepted,
        has_dead=has_dead,
        match_ok=accepted.all(1) & ~has_dead.any(1),
    )
    return cols, starts, ends


def match_substrs_native(model, chars: np.ndarray, lengths: np.ndarray) -> dict:
    """Witness generation for a ``CompiledRegexModel`` on the host, from
    the per-def native passes: the columns of ``ops.reference`` bit for bit
    (all of ``RegexResult``'s but start_enable and end_enable), as a dict of
    numpy arrays.  ``accepted`` is the final state against the def's
    accepted state, as in the JAX package."""
    return _native_passes(model, chars, lengths)[0]


def native_result(model, chars: np.ndarray, lengths: np.ndarray):
    """``match_substrs_native``'s columns with the per-def start_enable
    (the start flag at each enabled position) and end_enable (the end flag
    of each enabled position, unshifted): a whole ``RegexResult`` of
    numpy arrays from the native passes, such as the constraint checker
    (``witness.checker.check_witness_batch``) takes."""
    from ..witness.result import RegexResult

    cols, starts, ends = _native_passes(model, chars, lengths)
    enable = cols["all_enable_flags"]
    L = enable.shape[1]
    return RegexResult(
        **cols,
        start_enable=np.stack([enable * s[:, :L] for s in starts], 1),
        end_enable=np.stack([enable * e[:, 1:] for e in ends], 1),
    )


@functools.cache
def handoff_check_binary() -> Path:
    """The standalone C++ hand-off verifier (``handoff_check.cpp``), built
    with g++ at first use under the build root, keyed by a hash of its
    source and flags.  Raises where no g++ exists or the build fails."""
    from ..ops.kernels import build_root

    if not available():
        raise RuntimeError("handoff_check needs g++ on PATH")
    src = Path(__file__).resolve().parent / "handoff_check.cpp"
    flags = ("-O2", "-std=c++17")
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    exe = build_root() / "native" / key / "handoff_check"
    with _LOCK:
        if not exe.exists():
            exe.parent.mkdir(parents=True, exist_ok=True)
            tmp = exe.with_name(f"handoff_check.{os.getpid()}.{threading.get_ident()}")
            cmd = ["g++", *flags, str(src), "-o", str(tmp)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({res.returncode}) building {exe}:\n{' '.join(cmd)}\n{res.stderr}"
                )
            os.replace(tmp, exe)
    return exe


def handoff_check(path) -> subprocess.CompletedProcess:
    """Run the C++ hand-off verifier on the dump at ``path``: return code 0
    and "clean" on stdout for a dump that verifies, 1 with the violations
    on stderr for one that does not, 2 for a malformed file."""
    return subprocess.run([str(handoff_check_binary()), str(path)], capture_output=True,
                          text=True)
