"""CUDA kernels of the port: circuit codegen, nvcc build, ctypes binding,
launch counters.

The kernels themselves are under ``csrc/``.  The bitplane pipeline's are
static templates: ``bitplane_pack.cu`` (K1 qpack), ``bitplane_pack_raw.cu``
(pack from raw quad rows, B5), ``bitplane_tpack.cu`` (pack from the
pretiled quad words of the tiled input contract, B6), ``bitplane_scan.cu``
(K2; with ``H2R_SCAN_FUSED_PACK`` the in-scan pack ``scan_fpack``, with
``H2R_SCAN_DEF`` one def's scan ``scan_def``, B7), ``bitplane_post.cu``
(K3 in bytes mode; in planes mode when the header sets
``H2R_POST_PLANES``, in its tiled mode when it sets ``H2R_POST_TILED``,
in direct mode when it sets ``H2R_POST_DIRECT``; every mode runs over
chunks of L in three launches, ``CHUNKED_POSTS``),
``bitplane_decode.cu``
(the kdecode emission's decode, B14) and ``bitplane_fb.cu`` (the
match-only boundary reduction, B4).  What they compute per word depends
on the model and the knobs, so this module emits each def's synthesized
class, step and tag circuits, the knob modes and the post emission of the
plan's column set, as straight-line ``__device__ __forceinline__``
functions and defines into a header, ``h2r_circuits.cuh``, that the
templates include: one library per plan (model, column set, input layout
and knobs).  The table-driven matcher's kernels
(``table_scan.cu``, ``table_tag.cu``, ``table_fsm.cu`` of split mode and
``table_flat.cu`` of monolithic mode; :mod:`.pallas_scan`) take their
tables as data and need no header: one library for every model.  So do
the probes of ``tools/`` (the serial scans ``probe_tpu9.cu``,
``probe_tpu20.cu``, ``probe_tpu56.cu``; the table kernels'
``probe_gather.cu``, ``probe_dfa_step.cu``, ``probe_tpu18.cu``,
``probe_units.cu``; the emission, table-step and marker probes'
``probe_tile_move.cu``, ``probe_emit.cu``, ``probe_dfa_wide.cu``,
``probe_marker.cu``; the accumulate and int8 product probes'
``probe_mma_accum.cu`` and ``probe_int8_mma.cu`` on ``hopper_mma.cuh``,
whose tensor maps come from the driver's
``cuTensorMapEncodeTiled`` through the runtime's entry-point query, so the
link needs no libcuda; their wrappers are in :mod:`..probes`).

At first use each library's sources are compiled by nvcc for ``sm_90a``,
one nvcc per source, all at once, and linked into one shared library with a
plain C interface under ``<build root>/<hash of sources + header +
flags>/``, then loaded with ``ctypes``.  The build root is
``$H2R_TORCH_BUILD_DIR`` when set, else ``build/h2r_torch_kernels/`` in the
source checkout when that is writable, else ``h2r_torch_kernels/`` in the
user's cache directory (``$XDG_CACHE_HOME`` or ``~/.cache``), as for an
installed package.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (``torch.zeros`` where the kernel ORs into
them: the witness posts' ``fb``) unless the caller passes them, launches
on the current stream without synchronising, raises if
``cudaGetLastError`` reports a failed launch, and adds one to its
kernel's ``launches`` count.  Nothing here
runs on the CPU: the plain versions live in :mod:`.bitplane`,
:mod:`.pallas_scan` and the probe modules.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .bitplane import LANE, TILE, BitplanePlan
from .pallas_scan import FLAT_GROUP_DEFS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADERS = ("bitplane_common.cuh", "bitplane_pack_words.cuh")
TABLE_SOURCES = ("table_scan.cu", "table_tag.cu", "table_fsm.cu", "table_flat.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class CudaKernel:
    """One hand-written kernel: its C entry point, its source and the TPU
    kernel it replaces, and a plain count of launches."""

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        self.name = name
        self.entry = entry
        self.source = source
        self.replaces = replaces
        self.launches = 0


QPACK = CudaKernel(
    "qpack", "h2r_qpack", "halo2_regex_tpu_torch/csrc/bitplane_pack.cu",
    "halo2_regex_tpu/ops/bitplane.py:1138",
)
SCAN = CudaKernel(
    "scan", "h2r_scan", "halo2_regex_tpu_torch/csrc/bitplane_scan.cu",
    "halo2_regex_tpu/ops/bitplane.py:934",
)
POST = CudaKernel(
    "post", "h2r_post", "halo2_regex_tpu_torch/csrc/bitplane_post.cu",
    "halo2_regex_tpu/ops/bitplane.py:1338",
)
PACK_RAW = CudaKernel(
    "pack_raw", "h2r_pack_raw", "halo2_regex_tpu_torch/csrc/bitplane_pack_raw.cu",
    "halo2_regex_tpu/ops/bitplane.py:1040",
)
POST_PLANES = CudaKernel(
    "post_planes", "h2r_post_planes", "halo2_regex_tpu_torch/csrc/bitplane_post.cu",
    "halo2_regex_tpu/ops/bitplane.py:1338",
)
FB_ONLY = CudaKernel(
    "fb_only", "h2r_fb_only", "halo2_regex_tpu_torch/csrc/bitplane_fb.cu",
    "halo2_regex_tpu/ops/bitplane.py:1606",
)
TPACK = CudaKernel(
    "tpack", "h2r_tpack", "halo2_regex_tpu_torch/csrc/bitplane_tpack.cu",
    "halo2_regex_tpu/ops/bitplane.py:1243",
)
POST_TILED = CudaKernel(
    "post_tiled", "h2r_post_tiled", "halo2_regex_tpu_torch/csrc/bitplane_post.cu",
    "halo2_regex_tpu/ops/bitplane.py:1338 (tiled mode, :1455-1470)",
)
TABLE_SCAN = CudaKernel(
    "table_scan", "h2r_table_scan", "halo2_regex_tpu_torch/csrc/table_scan.cu",
    "halo2_regex_tpu/ops/pallas_scan.py:756, :1039",
)
TABLE_TAG = CudaKernel(
    "table_tag", "h2r_table_tag", "halo2_regex_tpu_torch/csrc/table_tag.cu",
    "halo2_regex_tpu/ops/pallas_scan.py:866, :1090",
)
TABLE_FSM = CudaKernel(
    "table_fsm", "h2r_table_fsm", "halo2_regex_tpu_torch/csrc/table_fsm.cu",
    "halo2_regex_tpu/ops/pallas_scan.py:898, :1145, :1168",
)
TABLE_FLAT = CudaKernel(
    "table_flat", "h2r_table_flat", "halo2_regex_tpu_torch/csrc/table_flat.cu",
    "halo2_regex_tpu/ops/pallas_scan.py:708 (body :509)",
)
SCAN_FPACK = CudaKernel(
    "scan_fpack", "h2r_scan_fpack", "halo2_regex_tpu_torch/csrc/bitplane_scan.cu",
    "halo2_regex_tpu/ops/bitplane.py:934 (fused_pack prologue :947-958)",
)
SCAN_DEF = CudaKernel(
    "scan_def", "h2r_scan_def", "halo2_regex_tpu_torch/csrc/bitplane_scan.cu",
    "halo2_regex_tpu/ops/bitplane.py:836",
)
POST_DIRECT = CudaKernel(
    "post_direct", "h2r_post_direct", "halo2_regex_tpu_torch/csrc/bitplane_post.cu",
    "halo2_regex_tpu/ops/bitplane.py:1338 (direct mode, :1471-1492)",
)
DECODE = CudaKernel(
    "decode", "h2r_decode", "halo2_regex_tpu_torch/csrc/bitplane_decode.cu",
    "halo2_regex_tpu/ops/bitplane.py:1666",
)
KERNELS = (QPACK, PACK_RAW, SCAN, POST, POST_PLANES, FB_ONLY,
           TABLE_SCAN, TABLE_TAG, TABLE_FSM, TPACK, POST_TILED, TABLE_FLAT,
           SCAN_FPACK, SCAN_DEF, POST_DIRECT, DECODE)
# the probes of tools/ (``probes/``): one library, no model; first the serial scans
LOOP_FLOOR = CudaKernel(
    "loop_floor", "h2r_loop_floor", "halo2_regex_tpu_torch/csrc/probe_tpu9.cu",
    "tools/probe_tpu9.py:62, :92 (ka :53, kb :79)",
)
SLAB_SCAN = CudaKernel(
    "slab_scan", "h2r_slab_scan", "halo2_regex_tpu_torch/csrc/probe_tpu9.cu",
    "tools/probe_tpu9.py:164 (kc :120)",
)
BITOP_SCAN = CudaKernel(
    "bitop_scan", "h2r_bitop_scan", "halo2_regex_tpu_torch/csrc/probe_tpu20.cu",
    "tools/probe_tpu20.py:74 (make_scan_probe :42)",
)
CHAINS = CudaKernel(
    "chains", "h2r_chains", "halo2_regex_tpu_torch/csrc/probe_tpu56.cu",
    "tools/probe_tpu56.py:71 (make_chains_kernel :61)",
)
# bitop_scan's table form: its table T, built once a device and n_ops
BITOP_TABLE = CudaKernel(
    "bitop_table", "h2r_bitop_table", "halo2_regex_tpu_torch/csrc/probe_tpu20.cu",
    "tools/probe_tpu20.py:74 (make_scan_probe :42)",
)
SERIAL_PROBES = (LOOP_FLOOR, SLAB_SCAN, BITOP_SCAN, CHAINS, BITOP_TABLE)
# the table-kernel probes of tools/ (probe_tpu, 2, 3, 17, 18)
LANE_GATHER = CudaKernel(
    "lane_gather", "h2r_lane_gather", "halo2_regex_tpu_torch/csrc/probe_gather.cu",
    "tools/probe_tpu.py:98, :118, :142 (k3, k4, k5); tools/probe_tpu2.py:208 (E k3); "
    "tools/probe_tpu3.py:47 (k1, k3)",
)
DFA_STEP = CudaKernel(
    "dfa_step", "h2r_dfa_step", "halo2_regex_tpu_torch/csrc/probe_dfa_step.cu",
    "tools/probe_tpu.py:180, :224 (k6, k7); tools/probe_tpu2.py:118, :169 (C k, D k2); "
    "tools/probe_tpu3.py:47 (make_scan_fullwidth, make_scan_select)",
)
SLAB_ANATOMY = CudaKernel(
    "slab_anatomy", "h2r_slab_anatomy", "halo2_regex_tpu_torch/csrc/probe_tpu18.cu",
    "tools/probe_tpu18.py:97 (kernel of build :51)",
)
NOP = CudaKernel(
    "nop", "h2r_nop", "halo2_regex_tpu_torch/csrc/probe_units.cu",
    "tools/probe_tpu2.py:59 (A knop)",
)
ONEHOT_COUNT = CudaKernel(
    "onehot_count", "h2r_onehot_count", "halo2_regex_tpu_torch/csrc/probe_units.cu",
    "tools/probe_tpu2.py:247 (F k4)",
)
INT8_MMA = CudaKernel(
    "int8_mma", "h2r_int8_mma", "halo2_regex_tpu_torch/csrc/probe_int8_mma.cu",
    "tools/probe_tpu17.py:83 (k)",
)
TABLE_PROBES = (LANE_GATHER, DFA_STEP, SLAB_ANATOMY, NOP, ONEHOT_COUNT, INT8_MMA)
# the emission and decode probes of tools/ (probe_tpu47, 48, 64, 68)
TILE_MOVE = CudaKernel(
    "tile_move", "h2r_tile_move", "halo2_regex_tpu_torch/csrc/probe_tile_move.cu",
    "tools/probe_tpu47.py:44, :60 (kern_t, kern_c); tools/probe_tpu48.py:84 (kern_id); "
    "tools/probe_tpu64.py:161 (kern_copy :128, kern_swap :131)",
)
L4_PACK = CudaKernel(
    "l4_pack", "h2r_l4_pack", "halo2_regex_tpu_torch/csrc/probe_emit.cu",
    "tools/probe_tpu48.py:65 (kern_direct); tools/probe_tpu64.py:161 (kern_mxu :134)",
)
FIELD_DECODE = CudaKernel(
    "field_decode", "h2r_field_decode", "halo2_regex_tpu_torch/csrc/probe_emit.cu",
    "tools/probe_tpu64.py:316 (make_mxdecode); tools/probe_tpu68.py:152 (make_decode)",
)
EMIT_PROBES = (TILE_MOVE, L4_PACK, FIELD_DECODE)
# the launch, accumulate, carry, class-chain and configs[3] table-step probes
# of tools/ (probe_tpu67, 21, 20 D-E, 6, 7, 28, 30, 31, 32)
MMA_ACCUM = CudaKernel(
    "mma_accum", "h2r_mma_accum", "halo2_regex_tpu_torch/csrc/probe_mma_accum.cu",
    "tools/probe_tpu21.py:112 (D mm_kern :97); tools/probe_tpu20.py:226 (D mm_kern :211)",
)
BITOP_CARRY = CudaKernel(
    "bitop_carry", "h2r_bitop_carry", "halo2_regex_tpu_torch/csrc/probe_tpu20.cu",
    "tools/probe_tpu20.py:267 (E kern2 :246)",
)
CLASS_CHAIN = CudaKernel(
    "class_chain", "h2r_class_chain", "halo2_regex_tpu_torch/csrc/probe_units.cu",
    "tools/probe_tpu6.py:186 (k4 :174)",
)
DFA_WIDE = CudaKernel(
    "dfa_wide", "h2r_dfa_wide", "halo2_regex_tpu_torch/csrc/probe_dfa_wide.cu",
    "tools/probe_tpu6.py:98 (k2 :72); tools/probe_tpu7.py:80 (scan_kernel :28); "
    "tools/probe_tpu28.py:40 (try_variant :32: v1 :66, v2 :92); tools/probe_tpu30.py:76, :104 "
    "(w1 :65, w2 :99); tools/probe_tpu31.py:56 (build :24); tools/probe_tpu32.py:82, :115 "
    "(build :26)",
)
T2_PROBES = (MMA_ACCUM, BITOP_CARRY, CLASS_CHAIN, DFA_WIDE)
# the marker-stream matcher of tools/ (probe_tpu57 B-C, probe_tpu61 C)
MARKER_MATCH = CudaKernel(
    "marker_match", "h2r_marker_match", "halo2_regex_tpu_torch/csrc/probe_marker.cu",
    "tools/probe_tpu57.py:198, tools/probe_tpu61.py:237 (make_marker_kernel :190, :228)",
)
T2C_PROBES = (MARKER_MATCH,)
PROBE_KERNELS = SERIAL_PROBES + TABLE_PROBES + EMIT_PROBES + T2_PROBES + T2C_PROBES
PROBE_SOURCES = ("probe_tpu9.cu", "probe_tpu20.cu", "probe_tpu56.cu", "probe_gather.cu",
                 "probe_dfa_step.cu", "probe_tpu18.cu", "probe_units.cu",
                 "probe_tile_move.cu", "probe_emit.cu", "probe_dfa_wide.cu", "probe_marker.cu",
                 "probe_mma_accum.cu", "probe_int8_mma.cu")
PROBE_HEADERS = ("probe_ring.cuh", "probe_lookback.cuh", "probe_slab.cuh",
                 "bitplane_common.cuh", "probe_marker_class.cuh", "hopper_mma.cuh")
# entry points of each library: (kernel, ctypes argument kinds)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    # the pack kernels' en is a null pointer when the plan's en_pack is off
    QPACK: [_P, _P, _P, _P, _I, _I, _I, _P],
    PACK_RAW: [_P, _P, _P, _P, _I, _I, _P],
    SCAN: [_P, _P, _I, _I, _P],
    SCAN_FPACK: [_P, _P, _I, _I, _P],
    SCAN_DEF: [_P, _P, _I, _I, _P],
    # the chunked posts: logs, en, scratch, outputs, NW, L, CL, stream
    POST: [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    POST_PLANES: [_P, _P, _P, _P, _I, _I, _I, _P],
    POST_DIRECT: [_P, _P, _P, _P, _I, _I, _I, _P],
    # g4, chars (l4), out, NWS, L, stream
    DECODE: [_P, _P, _P, _I, _I, _P],
    FB_ONLY: [_P, _P, _P, _I, _I, _P],
    TPACK: [_P, _P, _P, _P, _I, _I, _P],
    POST_TILED: [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # chars, cmap, next, next16, init, init def stride, states, scratch,
    # repaired, n_defs, B, L, K, S, p0, LS, C, W, warps, vec, smem bytes,
    # stream
    TABLE_SCAN: [_P, _P, _P, _P, _P, _LL, _P, _P, _P] + [_I] * 12 + [_P],
    # states, prev, prev def stride, lengths, pairs, P, ids, start, endf,
    # n_defs, B, L, p0, LS, stream
    TABLE_TAG: [_P, _P, _LL, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dirs, ids, start, endf, forward entry / carry ids / carry x / carry
    # def stride, the same backward, fwd, bwd, scratch, n_defs, B, L, p0,
    # LS, CL, stream
    TABLE_FSM: [_I, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P, _P]
    + [_I] * 6 + [_P],
    # chars, lengths, cmap, table, first, states, ids, start, endf, fwd,
    # bwd, bits, n_defs, B, L, K, S, vec, smem bytes, stream
    TABLE_FLAT: [_P] * 12 + [_I] * 7 + [_P],
    # x, out, slab, L, TB, chunk (0: serial), scratch, epoch, stream
    LOOP_FLOOR: [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    # tk, classes, x, four outputs, L, TB, K, S, chunk (0: serial), scratch,
    # epoch, stream
    SLAB_SCAN: [_P] * 7 + [_I] * 5 + [_P, _I, _P],
    # cls, st0, T (null: the serial form), out, n_ops, NW, L, LC, stream
    BITOP_SCAN: [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # T, n_ops, stream
    BITOP_TABLE: [_P, _I, _P],
    # x, out, C, NW, n_steps, threads a block, steps a warp (null: the
    # serial form), stream
    CHAINS: [_P, _P, _I, _I, _I, _I, _P, _P],
    # g (or t), f (or c), out, R, steps, form (0, 1 serial; 2 rows; 3, 4 pow), stream
    LANE_GATHER: [_P, _P, _P, _I, _I, _I, _P],
    # T (or Tk), classes, chars, out, TB, LB, time_major, form, pick, K, stream
    DFA_STEP: [_P] * 4 + [_I] * 6 + [_P],
    # tk, classes, x, four outputs, L, TB, K, S, first, n_out, chunk (0:
    # serial), scratch, epoch, stream
    SLAB_ANATOMY: [_P] * 7 + [_I] * 7 + [_P, _I, _P],
    # x, out, n, stream
    NOP: [_P, _P, _I, _P],
    # c, out, LB, TB, stream
    ONEHOT_COUNT: [_P, _P, _I, _I, _P],
    # a, b, c, scratch, M, N, K, stream
    INT8_MMA: [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, y, N, R, C, form, stream
    TILE_MOVE: [_P, _P, _I, _I, _I, _I, _P],
    # words, out, A, M, L, form, stream
    L4_PACK: [_P, _P, _I, _I, _I, _I, _P],
    # g4, ch, out, fields (host ints), n_fields, NWS, G, L, form, stream
    FIELD_DECODE: [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a, b, c, NI, NL, M, N, K, stream
    MMA_ACCUM: [_P, _P, _P] + [_I] * 5 + [_P],
    # cls, st0, out, NB, NW, L, LC, steps, cluster (0: the serial form), stream
    BITOP_CARRY: [_P, _P, _P] + [_I] * 6 + [_P],
    # c, out, n, thresholds and deltas (host ints), n_terms, form, stream
    CLASS_CHAIN: [_P, _P, _LL, _P, _P, _I, _I, _P],
    # T, frags, chars, entry, out, scratch, repaired, TB, L, K, W, hilo, cmod,
    # smod, form, in_smem, C, W (warm-up), stream
    DFA_WIDE: [_P] * 7 + [_I] * 11 + [_P],
    # stack, out, NW, L, chunk (0: serial), stream
    MARKER_MATCH: [_P, _P, _I, _I, _I, _P],
}
TABLE_KERNELS = (TABLE_SCAN, TABLE_TAG, TABLE_FSM, TABLE_FLAT)
# the post modes, all over chunks of L: each call launches the chunk maps
# (A), the carries (B) and the replay (C), all counted on the kernel
CHUNKED_POSTS = (POST, POST_TILED, POST_PLANES, POST_DIRECT)
_CHUNK_ENTRIES = {
    "h2r_post_maps": [_P, _P, _P, _I, _I, _I, _P],  # logs, en, scratch, NW, L, CL, stream
    "h2r_post_carry": [_P, _I, _I, _I, _P],  # scratch, NW, L, CL, stream
}
# positions a chunk (at most CL_MAX of csrc/bitplane_post.cu; direct mode: a multiple of 4)
POST_CL = 32


def _tail(plan: BitplanePlan) -> Tuple[CudaKernel, ...]:
    """The kernels after the scan: none where ``post="xla"`` runs torch ops."""
    if plan.columns == "match":
        return (FB_ONLY,)
    if plan.post == "xla":
        return ()
    if plan.columns == "full" or plan.emit == "planes":
        return (POST_PLANES,)
    if plan.emit == "direct":
        return (POST_DIRECT,)
    post_k = POST_TILED if plan.tiled else POST
    return (post_k, DECODE) if plan.emit == "kdecode" else (post_k,)


def path_kernels(plan: BitplanePlan) -> Tuple[CudaKernel, ...]:
    """The kernels one call of ``plan``'s pipeline launches, in order."""
    if plan.fuse_pack:
        return (SCAN_FPACK,) + _tail(plan)
    front = TPACK if plan.tiled else (QPACK if plan.qpack else PACK_RAW)
    return (front, SCAN) + _tail(plan)


def path_launches(plan: BitplanePlan) -> Dict[CudaKernel, int]:
    """Launches of each kernel in one call of ``plan``'s pipeline: one for
    each of ``path_kernels``, three for a chunked post."""
    return {k: 3 if k in CHUNKED_POSTS else 1 for k in path_kernels(plan)}


def library_kernels(plan: BitplanePlan) -> Tuple[CudaKernel, ...]:
    """The kernels of ``plan``'s library: its path's, and for a [B, L]
    plan with a pack kernel both packs (qpack and pack_raw)."""
    if plan.fuse_pack or plan.tiled:
        return path_kernels(plan)
    return (QPACK, PACK_RAW, SCAN) + _tail(plan)


def _sources(kernels_: Sequence[CudaKernel]) -> Tuple[str, ...]:
    """The csrc/ files of ``kernels_``, each once (a template serves
    several kernels, each selected by the generated header)."""
    return tuple(dict.fromkeys(Path(k.source).name for k in kernels_))


def table_path_launches(matcher, B: int) -> Dict[CudaKernel, int]:
    """Launches of one call of ``matcher`` (a ``PallasMatcher`` on the card)
    on ``B`` strings: in monolithic mode one flat kernel; in split mode one
    pass over [0, L) whatever the windows: the scan (one launch, or two in
    its chunked form), the tag, and both FSMs (one launch in their one-pass
    form, three in their chunked form)."""
    if matcher.mode == "monolithic":
        return {TABLE_FLAT: 1}
    dev = matcher.device
    scan = 2 if table_scan_form(matcher.n_defs, B, matcher.L, dev)[0] else 1
    return {TABLE_SCAN: scan, TABLE_TAG: 1, TABLE_FSM: 3 if table_fsm_form(B, dev) else 1}


def scan_path_launches(matcher, B: int) -> Dict[CudaKernel, int]:
    """Launches of one call of ``matcher`` (a ``BatchMatcher`` on the card)
    on ``B`` strings: the table scan alone, one launch in its serial form
    and two in its chunked form; the rest of the call is torch ops."""
    C = table_scan_form(matcher.n_defs, B, matcher.L, matcher.device)[0]
    return {TABLE_SCAN: 2 if C else 1}


def reset_launch_counts() -> None:
    for k in KERNELS + PROBE_KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Codegen: circuits -> h2r_circuits.cuh
# ---------------------------------------------------------------------------


def _fn(signature: str, body: List[str]) -> List[str]:
    return (
        [f"static __device__ __forceinline__ void {signature} {{"]
        + ["  " + line for line in body]
        + ["}", ""]
    )


def _c_plane_add(a: List[str], b: List[str], n_out: int, tmp) -> Tuple[List[str], List[str]]:
    """C version of ``bitplane.plane_add`` on named words: returns the
    output expressions and the statements that compute them."""
    lines: List[str] = []
    out: List[str] = []
    carry = None
    for j in range(n_out):
        x = a[j] if j < len(a) else None
        y = b[j] if j < len(b) else None
        terms = [t for t in (x, y, carry) if t is not None]
        if not terms:
            out.append("0u")
            continue
        s = terms[0]
        c = None
        for t in terms[1:]:
            nc, ns = tmp(), tmp()
            lines.append(f"const uint32_t {nc} = {s} & {t};")
            lines.append(f"const uint32_t {ns} = {s} ^ {t};")
            s = ns
            if c is None:
                c = nc
            else:
                cc = tmp()
                lines.append(f"const uint32_t {cc} = {c} | {nc};")
                c = cc
        out.append(s)
        carry = c
    return out, lines


def circuits_header(plan: BitplanePlan) -> str:
    """The per-model header the kernel templates include (see
    ``csrc/bitplane_common.cuh`` for the functions it must define)."""
    circ = plan.circuits
    live_off, off = [], 0
    for c in circ:
        live_off.append(off)
        off += len(c.live_states)
    n_live = off
    out = [
        "// Generated by halo2_regex_tpu_torch/ops/kernels.py from the",
        "// synthesized circuits of one model.  Do not edit.",
        "#pragma once",
        "",
        f"#define H2R_NDEFS {plan.n_defs}",
        f"#define H2R_KP {plan.kp}",
        f"#define H2R_SB_SUM {plan.sb_sum}",
        f"#define H2R_NLIVE {n_live}",
        f"#define H2R_NSUM {plan.nsum}",
        f"#define H2R_NDT {plan.n_defs * (plan.idb + 2)}",
        f"#define H2R_EN_PACK {int(plan.en_pack)}",
        f"#define H2R_SCAN_UNROLL {plan.unroll}",
    ]
    if plan.fuse_pack:
        out.append("#define H2R_SCAN_FUSED_PACK 1")
    # the witness emission's byte groups: bytes/kdecode pack fields into
    # <= 8-bit groups; direct stages each field's planes instead
    groups: Tuple = ()
    direct = plan.columns == "witness" and plan.emit == "direct"
    if plan.columns == "witness" and plan.emit in ("bytes", "kdecode"):
        groups = plan.wgroups
    elif direct:
        out += ["#define H2R_POST_DIRECT 1", f"#define H2R_DFIELDS {len(plan.dfields)}"]
    if groups:
        out.append(f"#define H2R_NGROUPS {len(groups)}")
        if plan.tiled:
            out.append("#define H2R_POST_TILED 1")
    if plan.post_off and plan.post == "pallas":
        out += ["#define H2R_POST_PLANES 1", f"#define H2R_P_TOTAL {plan.p_total}"]
        out += [f"#define H2R_OFF_{name.upper()} {o}" for name, (o, _nb) in plan.post_off.items()
                if not name[-1].isdigit()]
    if plan.emit == "kdecode":
        out += [f"#define H2R_NFIELDS {len(plan.fields_flat)}",
                "#define H2R_FLAGS_FIELD 0  // flags is the first field"]
    out.append("")

    if plan.class_stage:
        body = []
        for d, c in enumerate(circ):
            body.append(f"{{  // def {d}: {c.class_prog.n_ops} ops")
            body += ["  " + s for s in c.class_prog.to_c(
                {f"byte_bit{j}": f"bb[{j}]" for j in range(8)},
                {n: f"cls[{plan.cls_off[d] + j}]" for j, n in enumerate(c.class_plane_names)},
            )]
            body.append("}")
    else:  # the class stage is off: the pack writes the byte-bit planes
        body = [f"cls[{j}] = bb[{j}];" for j in range(8)]
    out += _fn("h2r_class(const uint32_t* bb, uint32_t* cls)", body)

    body = [
        f"st[{live_off[d] + i}] = {'0xFFFFFFFFu' if s == c.first_state else '0u'};"
        for d, c in enumerate(circ) for i, s in enumerate(c.live_states)
    ]
    out += _fn("h2r_step_init(uint32_t* st)", body)

    body = []
    for d, c in enumerate(circ):
        idx = {s: live_off[d] + i for i, s in enumerate(c.live_states)}
        if c.fold_class:  # the step circuit reads the 8 byte-bit planes
            ins = {f"byte_bit{j}": f"cls[{j}]" for j in range(8)}
        else:
            ins = {n: f"cls[{plan.cls_off[d] + j}]" for j, n in enumerate(c.class_plane_names)}
        ins.update({f"st{s}": f"st[{i}]" for s, i in idx.items()})
        outs = {f"nst{s}": f"st[{i}]" for s, i in idx.items()}
        outs.update({f"log{j}": f"lg[{plan.sb_off[d] + j}]" for j in range(c.sb)})
        body.append(f"{{  // def {d}: {c.step_prog.n_ops} ops")
        body += ["  " + s for s in c.step_prog.to_c(ins, outs)]
        body.append("}")
    out += _fn("h2r_step(const uint32_t* cls, uint32_t* st, uint32_t* lg)", body)

    body = [
        f"lg[{plan.sb_off[d] + j}] = {'0xFFFFFFFFu' if plan.first_bit(d, j) else '0u'};"
        for d, c in enumerate(circ) for j in range(c.sb)
    ]
    out += _fn("h2r_first_log(uint32_t* lg)", body)

    n_tmp = [0]

    def tmp() -> str:
        n_tmp[0] += 1
        return f"s{n_tmp[0]}"

    # dt[(idb + 2) * d + k]: def d's id planes, is_start, is_end, the
    # order of the planes-mode post output (post_off)
    body = []
    ids_sum: List[str] = []
    for d, c in enumerate(circ):
        idp = [f"id{d}_{j}" for j in range(plan.idb)]
        body.append(f"uint32_t {', '.join(idp)}, st{d}, ef{d};")
        ins = {f"prev{j}": f"prev[{plan.sb_off[d] + j}]" for j in range(c.sb)}
        ins.update({f"next{j}": f"next[{plan.sb_off[d] + j}]" for j in range(c.sb)})
        outs = {f"id{j}": idp[j] for j in range(plan.idb)}
        outs.update(is_start=f"st{d}", is_end=f"ef{d}")
        body.append(f"{{  // def {d}: {c.tag_prog.n_ops} ops")
        body += ["  " + s for s in c.tag_prog.to_c(ins, outs)]
        body.append("}")
        body += [f"{v} &= en;" for v in idp + [f"st{d}", f"ef{d}"]]
        body += [f"dt[{(plan.idb + 2) * d + k}] = {v};"
                 for k, v in enumerate(idp + [f"st{d}", f"ef{d}"])]
        if d == 0:
            ids_sum = idp
            body += ["start_any = st0;", "endf_any = ef0;"]
        else:
            ids_sum, lines = _c_plane_add(ids_sum, idp, plan.idb + d.bit_length() + 1, tmp)
            body += lines
            body += [f"start_any |= st{d};", f"endf_any |= ef{d};"]
    body += [f"ids[{k}] = {v};" for k, v in enumerate(ids_sum)]
    out += _fn(
        "h2r_tag(const uint32_t* prev, const uint32_t* next, uint32_t en, "
        "uint32_t* ids, uint32_t& start_any, uint32_t& endf_any, uint32_t* dt)",
        body,
    )

    body = []
    for d, c in enumerate(circ):
        for j in range(8):
            if j < c.sb:
                v = f"acc[{plan.sb_off[d] + j}]"
                if plan.first_bit(d, j):
                    v += " | empty"
            else:
                v = "0u"
            body.append(f"fb[{8 * d + j}] = {v};")
    out += _fn("h2r_fb(const uint32_t* acc, uint32_t empty, uint32_t* fb)", body)
    if not groups and not direct:
        return "\n".join(out)
    if plan.emit == "kdecode":
        # fw[f] = field f of the byte-group words gw[gi] (every byte lane)
        body = [f"fw[{f}] = (gw[{gi}] >> {off}) & {((1 << nb) - 1) * 0x01010101:#010x}u;"
                for f, (_name, gi, off, nb) in enumerate(plan.fields_flat)]
        out += _fn("h2r_decode_fields(const uint32_t* gw, uint32_t* fw)", body)

    avail: Dict[str, List[str]] = {
        "flags": [f"flags[{k}]" for k in range(6)],
        "masked_idsum": [f"midsum[{k}]" for k in range(plan.nsum)],
        "masked_characters_pre": [f"mcp[{j}]" for j in range(8)],
    }
    for d, c in enumerate(circ):
        avail[f"states{d}"] = [
            f"(lg[{plan.sb_off[d] + j}] & en)"
            + (" | ~en" if (plan.dummy_states[d] >> j) & 1 else "")
            for j in range(c.sb)
        ]
    if direct:
        # every field's planes of one position, in field order, and where
        # field f's planes start among them and how many it has
        planes = [p for name, _nb in plan.dfields for p in avail[name]]
        out.append(f"#define H2R_DPLANES {len(planes)}")
        out += _fn(
            "h2r_direct_planes(const uint32_t* flags, const uint32_t* midsum, "
            "const uint32_t* lg, uint32_t en, uint32_t* pl)",
            [f"pl[{k}] = {v};" for k, v in enumerate(planes)],
        )
        body, off = ["switch (f) {"], 0
        for f, (name, _nb) in enumerate(plan.dfields):
            n = len(avail[name])
            label = "default" if f == len(plan.dfields) - 1 else f"case {f}"
            body.append(f"  {label}: off = {off}; nb = {n}; break;  // {name}")
            off += n
        out += _fn("h2r_direct_field(int f, int& off, int& nb)", body + ["}"])
        return "\n".join(out)
    body = []
    for gi, grp in enumerate(groups):
        planes = [p for name, _off, _nb in grp for p in avail[name]]
        planes += ["0u"] * (8 - len(planes))
        body.append(f"{{  // group {gi}: {', '.join(n for n, _o, _b in grp)}")
        body.append(f"  uint32_t p[8] = {{{', '.join(planes)}}};")
        body.append("  h2r_transpose8(p);")
        body.append(f"  for (int b = 0; b < 8; ++b) words[{8 * gi} + b] = p[b];")
        body.append("}")
    out += _fn(
        "h2r_emit(const uint32_t* flags, const uint32_t* midsum, "
        "const uint32_t* lg, uint32_t en, const uint32_t* mcp, uint32_t* words)",
        body,
    )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}
# one lock per library key: plans that share a header (the same model and
# column set at two lengths) may be built from several threads at once
_KEY_LOCKS: Dict[str, threading.Lock] = {}
# plan -> library, so a launch does not regenerate and hash the header
# (milliseconds of host time); plans hash by identity, and an entry goes
# with its plan.
_PLAN_LIBS: "weakref.WeakKeyDictionary[BitplanePlan, ctypes.CDLL]" = (
    weakref.WeakKeyDictionary()
)
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def build_root() -> Path:
    """Where the libraries are built (see the module docstring)."""
    if os.environ.get("H2R_TORCH_BUILD_DIR"):
        return Path(os.environ["H2R_TORCH_BUILD_DIR"])
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").is_file() and os.access(checkout, os.W_OK):
        return checkout / "build" / "h2r_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "h2r_torch_kernels"


def _build_library(
    sources: Sequence[str],
    entries: Sequence[CudaKernel],
    includes: Sequence[str] = (),
    header: Optional[str] = None,
    csrc: Optional[Path] = None,
) -> ctypes.CDLL:
    """Build (once per source state) and load the library of ``sources``
    (files under ``csrc``, the package's ``csrc/`` by default; ``includes``
    are the headers they include from there, hashed with them; ``header``
    the generated ``h2r_circuits.cuh``, if any), and bind ``entries``.  A
    failed build raises with nvcc's output."""
    csrc = csrc or CSRC
    h = hashlib.sha256()
    for name in tuple(sources) + tuple(includes):
        h.update((csrc / name).read_bytes())
    h.update((header or "").encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    with _KEY_LOCKS.setdefault(key, threading.Lock()):
        lib = _LIBS.get(key)
        if lib is None:
            lib = _LIBS[key] = _load(key, tuple(sources), header, entries, csrc)
    return lib


def _load(key: str, sources: Tuple[str, ...], header: Optional[str],
          entries: Sequence[CudaKernel], csrc: Path) -> ctypes.CDLL:
    """Build the library of ``key`` unless the build root holds it (one
    nvcc per source at once, then a link), then load it and bind
    ``entries``."""
    out_dir = build_root() / key
    so = out_dir / "libh2r.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        if header is not None:
            (out_dir / "h2r_circuits.cuh").write_text(header)
        nvcc, tag = _nvcc(), f"{os.getpid()}.{threading.get_ident()}"

        def run(cmd):
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {out_dir}:\n"
                    f"{' '.join(cmd)}\n{res.stderr}"
                )
            return res.stdout + res.stderr

        objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sources)) as pool:
            logs = list(pool.map(run, [
                [nvcc, *NVCC_FLAGS, f"-I{csrc}", f"-I{out_dir}", "-c", "-o", str(o),
                 str(csrc / src)]
                for src, o in zip(sources, objs)
            ]))
        tmp = out_dir / f"libh2r.{tag}.so"
        logs.append(run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
        secs = time.perf_counter() - t0
        (out_dir / "build.log").write_text("".join(logs))
        for o in objs:
            o.unlink()
        os.replace(tmp, so)  # atomic: a reader never sees a partial library
        defines = [ln.split(None, 1)[1] for ln in (header or "").splitlines()
                   if ln.startswith("#define")]
        BUILD_LOG[key] = {"seconds": secs, "dir": str(out_dir), "ptxas": "".join(logs),
                          "defines": defines}
    lib = ctypes.CDLL(str(so))
    names = {k.entry: _ENTRIES[k] for k in entries}
    if any(k in CHUNKED_POSTS for k in entries):
        names.update(_CHUNK_ENTRIES)
    for name, argtypes in names.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if INT8_MMA in entries:  # a, M, N, K -> the scratch bytes of an int8_mma call
        fn = lib.h2r_int8_mma_scratch
        fn.argtypes, fn.restype = [_P, _I, _I, _I], ctypes.c_longlong
    return lib


def build(plan: BitplanePlan) -> ctypes.CDLL:
    """The bitplane kernels' library for ``plan`` (built once per model,
    column set, input layout and source state)."""
    hit = _PLAN_LIBS.get(plan)
    if hit is not None:
        return hit
    ks = library_kernels(plan)
    lib = _build_library(_sources(ks), ks, includes=HEADERS, header=circuits_header(plan))
    _PLAN_LIBS[plan] = lib
    return lib


def def_plan(plan: BitplanePlan, d: int) -> BitplanePlan:
    """``plan`` narrowed to def ``d`` for its scan alone (``scan_def``):
    the input stack keeps all KP planes, def d's at ``cls_off[d]``, and
    the output holds its sb_d log planes."""
    c = plan.circuits[d]
    return dataclasses.replace(
        plan, circuits=(c,), columns="match", tiled=False, fuse_pack=False, nsum=plan.idb,
        cls_off=(plan.cls_off[d],), sb_off=(0,), sb_sum=c.sb, wgroups=(), post_off={},
        p_total=0, emit="planes", dfields=(), first_states=(plan.first_states[d],),
        dummy_states=(plan.dummy_states[d],),
    )


_DEF_LIBS: "weakref.WeakKeyDictionary[BitplanePlan, Dict[int, ctypes.CDLL]]" = (
    weakref.WeakKeyDictionary()
)


def build_scan_def(plan: BitplanePlan, d: int) -> ctypes.CDLL:
    """The library of ``scan_def`` for def ``d`` of ``plan``: the scan
    template built against the header of ``def_plan(plan, d)``."""
    libs = _DEF_LIBS.setdefault(plan, {})
    if d not in libs:
        header = circuits_header(def_plan(plan, d)).replace(
            "#pragma once\n", f"#pragma once\n#define H2R_SCAN_DEF 1  // def {d} alone\n", 1)
        libs[d] = _build_library(_sources((SCAN_DEF,)), (SCAN_DEF,), includes=HEADERS,
                                 header=header)
    return libs[d]


@functools.cache
def build_tables() -> ctypes.CDLL:
    """The table kernels' library (one for every model)."""
    lib = _build_library(TABLE_SOURCES, TABLE_KERNELS)
    lib.h2r_smem_optin.argtypes = []
    lib.h2r_smem_optin.restype = ctypes.c_int
    return lib


@functools.cache
def build_probes() -> ctypes.CDLL:
    """The probe kernels' library (``probes/``; one for every caller)."""
    return _build_library(PROBE_SOURCES, PROBE_KERNELS, includes=PROBE_HEADERS)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_aligned(t: torch.Tensor, name: str, nbytes: int):
    """Raise where ``t``'s first element is not ``nbytes``-aligned (a
    contiguous view at an odd storage offset), which a kernel's vector
    loads and stores need."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: expected a {nbytes}-byte aligned tensor (storage offset "
                         f"{t.storage_offset()})")


def _launch(kernel: CudaKernel, fn, *args, n: int = 1) -> None:
    """Call the C entry ``fn``, which launches ``n`` kernels of ``kernel``."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: launch failed, cudaError {err}")
    kernel.launches += n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# The probes' chunked scans (csrc/probe_tpu9.cu loop_floor, probe_slab.cuh):
# their forms, chunk lengths and the look-back's scratch
# ---------------------------------------------------------------------------

SCAN_FORMS = ("chunked", "serial")
SCAN_CHUNKS = (64, 128, 512)  # the chunked forms' instances: C, rows or positions a tile
SLAB_CHUNK_MAX_S = 32  # kChunkMaxS of csrc/probe_slab.cuh: a warp holds every start state
SLAB_CHUNK_WARPS = 8  # kChunkWarps: a block's warps, the sub-chunks of a chunk
LOOKBACK_TICKET_BYTES = 256  # kTicketBytes of csrc/probe_lookback.cuh
LOOKBACK_EPOCHS = 1 << 24  # epochs before the scratch starts again from zeros
# the look-back's status bytes a tile, each tile's at a fixed stride:
# loop_floor's 32 words of 8 bytes; the slab kernel's record (kRecordBytes),
# 32 maps of four 8-byte words, then 32 end-state words
LOOKBACK_TILE_BYTES = {LOOP_FLOOR.name: 32 * 8, SLAB_SCAN.name: 32 * 4 * 8 + 32 * 4,
                       SLAB_ANATOMY.name: 32 * 4 * 8 + 32 * 4}
_LOOKBACK: Dict[Tuple[int, int, str], list] = {}


def slab_form(S: int) -> str:
    """The slab kernel's form for a table of S states: ``"chunked"`` where a
    warp holds every start state of a string (S <= ``SLAB_CHUNK_MAX_S``),
    else ``"serial"``."""
    return "chunked" if S <= SLAB_CHUNK_MAX_S else "serial"


def scan_chunk(L: int, TB: int, dev: torch.device) -> int:
    """The chunk length C of the probes' chunked scans for [L, TB]: 512
    where its tiles (32 columns x C rows) are at least as many as the
    card's SMs, else 128 where they are, else 64 (``kernel_ab.py --only
    scan`` times other C)."""
    n_grp = -(-TB // 32)
    for c in (512, 128):
        if n_grp * -(-L // c) >= _sms(dev):
            return c
    return 64


def lookback_scratch(kernel: CudaKernel, t: torch.Tensor, n_blk: int) -> Tuple[int, int]:
    """The scratch of ``kernel``'s chunked form on ``t``'s device and
    current stream, for a grid of ``n_blk`` tiles, and the call's epoch:
    (pointer, epoch).  The scratch is made (and remade larger when a larger
    grid comes) as zeros: the ticket at 0 and no status word of any epoch.
    Each call takes the next epoch, so the status words of earlier calls
    read as not ready and nothing is filled between calls; after
    ``LOOKBACK_EPOCHS`` calls the scratch is zeroed and the epochs start
    again.  One scratch a kernel, so that an address holds the same kind of
    word in every call (tile t's words lie at t times
    ``LOOKBACK_TILE_BYTES``, whatever the grid), and one a stream, so that
    calls on two streams never share a ticket."""
    key = (_index(t.device), _stream(t), kernel.name)
    nbytes = LOOKBACK_TICKET_BYTES + n_blk * LOOKBACK_TILE_BYTES[kernel.name]
    ent = _LOOKBACK.get(key)
    if ent is None or ent[0].numel() < nbytes:
        ent = _LOOKBACK[key] = [torch.zeros(nbytes, dtype=torch.uint8, device=t.device), 0]
    ent[1] += 1
    if ent[1] >= LOOKBACK_EPOCHS:
        ent[0].zero_()
        ent[1] = 1
    return ent[0].data_ptr(), ent[1]


def qpack_cuda(plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor):
    """K1 (``csrc/bitplane_pack.cu``): same contract as ``qpack_plain``."""
    B, L = chars.shape
    if B % TILE or L != plan.L_pad:
        raise ValueError(f"chars {tuple(chars.shape)}: need B % {TILE} == 0 and L == {plan.L_pad}")
    NWS = B // TILE
    _check(chars, "chars", torch.uint8, (B, L))
    _check(len_wb, "len_wb", torch.int32, (NWS, LANE, 32))
    lib = build(plan)
    with torch.cuda.device(chars.device):
        bits = torch.empty((L, plan.kp, NWS, LANE), dtype=torch.int32, device=chars.device)
        en = _en_out(plan, NWS, chars.device)
        # 16-byte loads, else 4-byte loads, where length and address allow
        vec = next((v for v, n in ((2, 16), (1, 4)) if L % n == 0 and chars.data_ptr() % n == 0),
                   0)
        _launch(QPACK, lib.h2r_qpack, chars.data_ptr(), len_wb.data_ptr(),
                bits.data_ptr(), _ptr(en), B, L, vec, _stream(chars))
    return bits, en


def _en_out(plan: BitplanePlan, NWS: int, dev: torch.device) -> Optional[torch.Tensor]:
    """The pack kernels' enable plane output, or None when en_pack is off
    (the kernel then writes none, and torch ops build it)."""
    if not plan.en_pack:
        return None
    return torch.empty((NWS, plan.L_pad, LANE), dtype=torch.int32, device=dev)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def pack_raw_cuda(plan: BitplanePlan, quads: torch.Tensor, len_wb: torch.Tensor):
    """B5 (``csrc/bitplane_pack_raw.cu``): same contract as ``pack_plain``."""
    NWS = quads.shape[2] if quads.dim() == 4 else 0
    _check(quads, "quads", torch.int32, (plan.L_pad, 8, NWS, LANE))
    _check(len_wb, "len_wb", torch.int32, (NWS, LANE, 32))
    lib = build(plan)
    dev = quads.device
    with torch.cuda.device(dev):
        bits = torch.empty((plan.L_pad, plan.kp, NWS, LANE), dtype=torch.int32, device=dev)
        en = _en_out(plan, NWS, dev)
        _launch(PACK_RAW, lib.h2r_pack_raw, quads.data_ptr(), len_wb.data_ptr(),
                bits.data_ptr(), _ptr(en), NWS * LANE, plan.L_pad, _stream(quads))
    return bits, en


def tpack_cuda(plan: BitplanePlan, tiled: torch.Tensor, len_wb: torch.Tensor):
    """B6 (``csrc/bitplane_tpack.cu``): same contract as ``tpack_plain``."""
    NWS = tiled.shape[0] if tiled.dim() == 4 else 0
    _check(tiled, "tiled", torch.int32, (NWS, 8, plan.L_pad, LANE))
    _check(len_wb, "len_wb", torch.int32, (NWS, LANE, 32))
    lib = build(plan)
    dev = tiled.device
    with torch.cuda.device(dev):
        bits = torch.empty((plan.L_pad, plan.kp, NWS, LANE), dtype=torch.int32, device=dev)
        en = torch.empty((NWS, plan.L_pad, LANE), dtype=torch.int32, device=dev)
        _launch(TPACK, lib.h2r_tpack, tiled.data_ptr(), len_wb.data_ptr(), bits.data_ptr(),
                en.data_ptr(), NWS * LANE, plan.L_pad, _stream(tiled))
    return bits, en


def scan_cuda(plan: BitplanePlan, bits_stack: torch.Tensor) -> torch.Tensor:
    """K2 (``csrc/bitplane_scan.cu``): same contract as ``scan_plain``."""
    if plan.fuse_pack:
        raise ValueError("a fuse_pack plan's scan is scan_fpack_cuda")
    return _scan_launch(SCAN, build(plan), plan, bits_stack, plan.kp, plan.sb_sum)


def _scan_launch(kernel: CudaKernel, lib, plan: BitplanePlan, x: torch.Tensor, kin: int,
                 sb: int) -> torch.Tensor:
    """Launch one of the scans built from ``bitplane_scan.cu`` on its input
    planes [L_pad, kin, NWS, LANE] -> log planes [NWS, sb, L_pad, LANE]."""
    NWS = x.shape[2] if x.dim() == 4 else 0
    _check(x, "bits_stack", torch.int32, (plan.L_pad, kin, NWS, LANE))
    with torch.cuda.device(x.device):
        logs = torch.empty((NWS, sb, plan.L_pad, LANE), dtype=torch.int32, device=x.device)
        _launch(kernel, getattr(lib, kernel.entry), x.data_ptr(), logs.data_ptr(),
                NWS * LANE, plan.L_pad, _stream(x))
    return logs


def scan_fpack_cuda(plan: BitplanePlan, quads: torch.Tensor) -> torch.Tensor:
    """B2's fused_pack mode (``csrc/bitplane_scan.cu`` under
    ``H2R_SCAN_FUSED_PACK``): same contract as ``scan_fpack_plain``."""
    if not plan.fuse_pack:
        raise ValueError("scan_fpack needs a fuse_pack plan")
    return _scan_launch(SCAN_FPACK, build(plan), plan, quads, 8, plan.sb_sum)


def scan_def_cuda(plan: BitplanePlan, bits_stack: torch.Tensor, d: int) -> torch.Tensor:
    """B7 (``csrc/bitplane_scan.cu`` built for def ``d`` alone, under
    ``H2R_SCAN_DEF``): same contract as ``scan_def_plain``."""
    return _scan_launch(SCAN_DEF, build_scan_def(plan, d), plan, bits_stack, plan.kp,
                        plan.circuits[d].sb)


def _check_logs_en(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> int:
    NWS = logs.shape[0] if logs.dim() == 4 else 0
    _check(logs, "logs", torch.int32, (NWS, plan.sb_sum, plan.L_pad, LANE))
    _check(en, "en", torch.int32, (NWS, plan.L_pad, LANE))
    return NWS


def post_cuda(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor):
    """K3 (``csrc/bitplane_post.cu``, bytes mode): same contract as
    ``post_plain``."""
    if plan.tiled or plan.emit not in ("bytes", "kdecode"):
        raise ValueError("post needs a [B, L] witness plan in bytes or kdecode emission")
    NWS = _check_logs_en(plan, logs, en)
    L = plan.L_pad
    lib = build(plan)
    dev = logs.device
    with torch.cuda.device(dev):
        scr = _post_front(POST, lib, logs, en)
        g4 = torch.empty((NWS, 8 * plan.n_groups, L, LANE), dtype=torch.int32, device=dev)
        fb = torch.zeros((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=dev)
        _launch(POST, lib.h2r_post, logs.data_ptr(), en.data_ptr(), scr.data_ptr(),
                g4.data_ptr(), fb.data_ptr(), NWS * LANE, L, POST_CL, _stream(logs))
    return g4, fb


def _post_front(kernel: CudaKernel, lib, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Launches A and B of a chunked post: the chunk maps into a new
    [4, NCH, NW] scratch, then each chunk's carry-ins in place; returns
    the scratch, which launch C reads."""
    NW, L = logs.shape[0] * LANE, logs.shape[2]
    scr = torch.empty((4, -(-L // POST_CL), NW), dtype=torch.int32, device=logs.device)
    _launch(kernel, lib.h2r_post_maps, logs.data_ptr(), en.data_ptr(), scr.data_ptr(), NW, L,
            POST_CL, _stream(logs))
    _launch(kernel, lib.h2r_post_carry, scr.data_ptr(), NW, L, POST_CL, _stream(logs))
    return scr


def post_tiled_cuda(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor,
                    tiled: torch.Tensor):
    """B3's tiled mode (``csrc/bitplane_post.cu`` under ``H2R_POST_TILED``):
    same contract as ``post_plain`` with the quad words ``tiled``."""
    if not plan.tiled or plan.columns != "witness":
        raise ValueError("post_tiled needs a tiled witness plan")
    NWS = _check_logs_en(plan, logs, en)
    _check(tiled, "tiled", torch.int32, (NWS, 8, plan.L_pad, LANE))
    L = plan.L_pad
    lib = build(plan)
    dev = logs.device
    with torch.cuda.device(dev):
        scr = _post_front(POST_TILED, lib, logs, en)
        g4 = torch.empty((NWS, 8 * plan.n_groups, L, LANE), dtype=torch.int32, device=dev)
        fb = torch.zeros((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=dev)
        _launch(POST_TILED, lib.h2r_post_tiled, logs.data_ptr(), en.data_ptr(),
                tiled.data_ptr(), scr.data_ptr(), g4.data_ptr(), fb.data_ptr(), NWS * LANE, L,
                POST_CL, _stream(logs))
    return g4, fb


def post_planes_cuda(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """B3 planes mode (``csrc/bitplane_post.cu`` under ``H2R_POST_PLANES``):
    same contract as ``post_planes_plain``: a full plan's planes, or a
    witness plan's in planes emission."""
    if not plan.post_off or plan.post != "pallas":
        raise ValueError("post_planes needs a full or planes-emission plan with post='pallas'")
    NWS = _check_logs_en(plan, logs, en)
    lib = build(plan)
    dev = logs.device
    with torch.cuda.device(dev):
        scr = _post_front(POST_PLANES, lib, logs, en)
        out = torch.empty((NWS, plan.p_total, plan.L_pad, LANE), dtype=torch.int32, device=dev)
        _launch(POST_PLANES, lib.h2r_post_planes, logs.data_ptr(), en.data_ptr(),
                scr.data_ptr(), out.data_ptr(), NWS * LANE, plan.L_pad, POST_CL, _stream(logs))
    return out


def post_direct_cuda(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """B3's direct mode (``csrc/bitplane_post.cu`` under ``H2R_POST_DIRECT``):
    same contract as ``post_direct_plain``.  A chunked post: each chunk
    writes the columns of its positions, so ``POST_CL`` is a multiple of 4
    here (a 4-position column is one int32 of a row)."""
    if plan.emit != "direct":
        raise ValueError("post_direct needs a witness plan in direct emission")
    if POST_CL % 4:
        raise ValueError(f"direct emission writes 4-position columns: chunk length {POST_CL} "
                         "is not a multiple of 4")
    NWS = _check_logs_en(plan, logs, en)
    lib = build(plan)
    dev = logs.device
    with torch.cuda.device(dev):
        scr = _post_front(POST_DIRECT, lib, logs, en)
        out = torch.empty((len(plan.dfields), 8, NWS, 4 * LANE, plan.l4), dtype=torch.int32,
                          device=dev)
        _launch(POST_DIRECT, lib.h2r_post_direct, logs.data_ptr(), en.data_ptr(),
                scr.data_ptr(), out.data_ptr(), NWS * LANE, plan.L_pad, POST_CL, _stream(logs))
    return out


def decode_cuda(plan: BitplanePlan, g4: torch.Tensor, ch_l4: torch.Tensor) -> torch.Tensor:
    """B14 (``csrc/bitplane_decode.cu``): same contract as ``decode_plain``."""
    if plan.emit != "kdecode":
        raise ValueError("decode needs a witness plan in kdecode emission")
    NWS = g4.shape[0] if g4.dim() == 4 else 0
    _check(g4, "g4", torch.int32, (NWS, 8 * plan.n_groups, plan.L_pad, LANE))
    _check(ch_l4, "ch_l4", torch.int32, (NWS * TILE, plan.l4))
    lib = build(plan)
    dev = g4.device
    with torch.cuda.device(dev):
        out = torch.empty((len(plan.fields_flat) + 1, NWS * TILE, plan.l4), dtype=torch.int32,
                          device=dev)
        _launch(DECODE, lib.h2r_decode, g4.data_ptr(), ch_l4.data_ptr(), out.data_ptr(), NWS,
                plan.L_pad, _stream(g4))
    return out


def fb_only_cuda(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """B4 (``csrc/bitplane_fb.cu``): same contract as ``fb_only_plain``;
    one launch, each output word written once."""
    NWS = _check_logs_en(plan, logs, en)
    lib = build(plan)
    dev = logs.device
    with torch.cuda.device(dev):
        fb = torch.empty((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=dev)
        _launch(FB_ONLY, lib.h2r_fb_only, logs.data_ptr(), en.data_ptr(), fb.data_ptr(),
                NWS, plan.L_pad, _stream(logs))
    return fb


# ---------------------------------------------------------------------------
# The table-driven matcher's kernels (contracts: .pallas_scan)
# ---------------------------------------------------------------------------

_SMEM_OPTIN: Dict[int, int] = {}
TABLE_TAG_SMEM_PAIRS = 4096  # kSmemPairs of csrc/table_tag.cu: pairs staged in shared memory


def _check_row(t: torch.Tensor, name: str, n: int, B: int, dev: torch.device) -> None:
    """A carry row [n, B] int32 on ``dev``: contiguous along B, any stride
    between its rows (a row of a [n, L, B] plane is a view)."""
    if t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected torch.int32, got {t.dtype}")
    if tuple(t.shape) != (n, B):
        raise ValueError(f"{name}: expected shape {(n, B)}, got {tuple(t.shape)}")
    if B > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous along the batch")


def _check_window(p0: int, LS: int, L: int) -> None:
    if not (0 <= p0 and 0 < LS and p0 + LS <= L):
        raise ValueError(f"window [{p0}, {p0 + LS}) is not inside [0, {L})")


def _smem_optin(dev: torch.device) -> int:
    """The card's per-block shared-memory opt-in limit, in bytes."""
    if dev.index not in _SMEM_OPTIN:
        with torch.cuda.device(dev):
            _SMEM_OPTIN[dev.index] = build_tables().h2r_smem_optin()
    return _SMEM_OPTIN[dev.index]


def table_smem_bytes(K: int, S: int, dev: torch.device) -> int:
    """Shared memory the scan kernel stages its uint16 table (2 * next) in,
    or 0 when it reads the int32 table from global memory (more than 32768
    states, or a table beyond the card's opt-in limit less the kernel's
    1 KiB of static shared memory)."""
    need = 2 * K * S
    return need if S <= 32768 and need + 1024 <= _smem_optin(dev) else 0


def flat_smem_bytes(n_defs: int, K: int, S: int, optin: int) -> int:
    """Shared memory the flat kernel stages its packed int32 table in, or
    0 when the table does not fit the card's opt-in limit ``optin`` beside
    the kernel's static row-offset map (one group of defs: 8 KiB at most)
    and a margin: then the kernel reads the table from global memory.  A
    raw-bytes def (K = 256) at S = 256 needs 256 KiB, over the H100's
    227 KiB."""
    need = 4 * n_defs * K * S
    return need if need + 4 * FLAT_GROUP_DEFS * 256 + 1024 <= optin else 0


# the chunked scan's chunk length C and warm-up W (kernel_ab.py sweeps them
# at configs[3])
TABLE_SCAN_C, TABLE_SCAN_W = 512, 8192
TABLE_FSM_CL = 64  # the chunked FSMs' chunk length (at most kMaxCL of csrc/table_fsm.cu)
# the one-pass FSMs' backward codes: positions a 32-bit word, and the
# longest window whose codes the kernel keeps in shared memory (kCodeSpan,
# kCodeSmemMax of csrc/table_fsm.cu: 32 KiB a warp)
TABLE_FSM_CODE_SPAN = 16
TABLE_FSM_SMEM_LS = 32 * 1024 // 128 * TABLE_FSM_CODE_SPAN
_REPAIRED: Dict[int, torch.Tensor] = {}


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def table_scan_form(n_defs: int, B: int, LS: int, dev: torch.device) -> Tuple[int, int]:
    """``(C, W)`` of the scan's chunked form, or ``(0, 0)`` for its serial
    form: chunked when the strings of all defs are fewer than four warps an
    SM (the serial form would leave the card mostly idle) and the window is
    longer than twice a chunk's serial length W + C."""
    C, W = TABLE_SCAN_C, TABLE_SCAN_W
    if n_defs * -(-B // 32) >= 4 * _sms(dev) or LS <= 2 * (C + W):
        return 0, 0
    return C, W


def table_fsm_form(B: int, dev: torch.device) -> int:
    """Chunk length of the FSMs' chunked form, or 0 for the one-pass form
    when the batch's 32-string groups fill the card four times over."""
    return 0 if -(-B // 32) >= 4 * _sms(dev) else TABLE_FSM_CL


def _index(dev) -> int:
    dev = torch.device(dev)
    return torch.cuda.current_device() if dev.index is None else dev.index


def table_scan_repaired(dev: torch.device) -> int:
    """Positions the chunked scan's repair pass has overwritten on ``dev``
    since the process started (reads a device counter: synchronises)."""
    t = _REPAIRED.get(_index(dev))
    return 0 if t is None else int(t.item())


def table_scan_cuda(cmap, next_tab, chars, init, p0: int, LS: int, out, next16=None,
                    form: Optional[Tuple[int, int]] = None) -> None:
    """B8/B11 scan (``csrc/table_scan.cu``): same contract as
    ``pallas_scan.scan_plain``.  ``next16``: ``2 * next_tab`` as uint16
    bits in an int16 tensor, the shared-memory table (the matcher's
    ``next_table16``; made here when not given).  ``form``: ``(C, W)`` for
    the chunked form, ``(0, 0)`` for the serial one, ``None`` for
    ``table_scan_form``'s choice.  The chunked form counts as two launches
    (speculation, repair)."""
    n_defs, K, S = next_tab.shape
    B, L = chars.shape
    _check(cmap, "cmap", torch.int32, (n_defs, 256))
    _check(next_tab, "next_tab", torch.int32, (n_defs, K, S))
    _check(chars, "chars", torch.uint8, (B, L))
    _check(out, "out", torch.int32, (n_defs, L, B))
    _check_row(init, "init", n_defs, B, chars.device)
    _check_window(p0, LS, L)
    dev = chars.device
    C, W = table_scan_form(n_defs, B, LS, dev) if form is None else form
    if C < 0 or W < 0 or (C == 0 and W != 0):
        raise ValueError(f"form {(C, W)}: expected (0, 0) or (C > 0, W >= 0)")
    if B == 0:
        return
    lib = build_tables()
    smem = table_smem_bytes(K, S, dev)
    if smem and next16 is None:
        next16 = (next_tab * 2).to(torch.int16)
    if next16 is not None:
        _check(next16, "next16", torch.int16, (n_defs, K, S))
    scratch = repaired = None
    warps = 0
    if C:
        n_ch = -(-LS // C)
        scratch = torch.empty((2, n_defs, n_ch, B), dtype=torch.int32, device=dev)
        repaired = _REPAIRED.get(_index(dev))
        if repaired is None:
            repaired = _REPAIRED[_index(dev)] = torch.zeros(1, dtype=torch.int64, device=dev)
        # S1's warps a block: about one block an SM
        warps = min(32, max(1, -(-n_ch * -(-B // 32) // _sms(dev))))
    # 16-byte char loads for the aligned runs of a window
    vec = int(L % 16 == 0 and chars.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        _launch(TABLE_SCAN, lib.h2r_table_scan, chars.data_ptr(), cmap.data_ptr(),
                next_tab.data_ptr(), _ptr(next16), init.data_ptr(), init.stride(0),
                out.data_ptr(), _ptr(scratch), _ptr(repaired), n_defs, B, L, K, S, p0, LS,
                C, W, warps, vec, smem, _stream(chars), n=2 if C else 1)


def table_tag_cuda(states, prev, lengths, pairs, p0: int, LS: int, ids, start, endf) -> None:
    """B9/B11 tag (``csrc/table_tag.cu``): same contract as
    ``pallas_scan.tag_plain``, for any number of pairs per def (the first
    ``TABLE_TAG_SMEM_PAIRS`` in shared memory, the rest read from global
    memory)."""
    n_defs, L, B = states.shape
    P = pairs.shape[1] if pairs.dim() == 3 else -1
    _check(states, "states", torch.int32, (n_defs, L, B))
    _check(lengths, "lengths", torch.int32, (B,))
    _check(pairs, "pairs", torch.int32, (n_defs, P, 5))
    for name, t in (("ids", ids), ("start", start), ("endf", endf)):
        _check(t, name, torch.int32, (n_defs, L, B))
    _check_row(prev, "prev", n_defs, B, states.device)
    _check_window(p0, LS, L)
    if B == 0:
        return
    lib = build_tables()
    with torch.cuda.device(states.device):
        _launch(TABLE_TAG, lib.h2r_table_tag, states.data_ptr(), prev.data_ptr(),
                prev.stride(0), lengths.data_ptr(), pairs.data_ptr(), P, ids.data_ptr(),
                start.data_ptr(), endf.data_ptr(), n_defs, B, L, p0, LS, _stream(states))


def _check_carry(carry, n_defs: int, B: int, dev: torch.device):
    """(entry, carry_ids, carry_x) with ``None`` for zeros -> the same and
    the carry rows' def stride."""
    entry, carry_ids, carry_x = carry
    if (carry_ids is None) != (carry_x is None):
        raise ValueError("carry_ids and carry_x are given together or not at all")
    if carry_ids is not None:
        _check_row(carry_ids, "carry_ids", n_defs, B, dev)
        _check_row(carry_x, "carry_x", n_defs, B, dev)
        if carry_x.stride(0) != carry_ids.stride(0):
            raise ValueError("carry_ids and carry_x need the same row stride")
    if entry is not None:
        _check(entry, "entry", torch.int32, (B,))
    return entry, carry_ids, carry_x, 0 if carry_ids is None else carry_ids.stride(0)


def table_fsms_cuda(ids, start, endf, p0: int, LS: int, fwd=None, bwd=None,
                    fwd_carry=(None, None, None), bwd_carry=(None, None, None),
                    cl: Optional[int] = None) -> None:
    """B10/B11 mask FSMs (``csrc/table_fsm.cu``), the forward one into
    ``fwd`` and the backward one into ``bwd`` (either may be ``None``), in
    one call: each as ``pallas_scan.fsm_plain`` with its carries
    ``(entry, carry_ids, carry_x)`` (``None`` reaches the kernel as a null
    pointer, read as zeros).  ``cl``: the chunk length of the chunked form
    (three launches), 0 for the one-pass form (one launch for both
    directions), ``None`` for ``table_fsm_form``'s choice.  The one-pass
    form keeps the backward codes in shared memory up to
    ``TABLE_FSM_SMEM_LS`` positions, else in a global scratch
    [ceil(LS / 16), B] int32."""
    n_defs, L, B = ids.shape
    for name, t in (("ids", ids), ("start", start), ("endf", endf)):
        _check(t, name, torch.int32, (n_defs, L, B))
    if fwd is None and bwd is None:
        raise ValueError("neither fwd nor bwd given")
    for name, t in (("fwd", fwd), ("bwd", bwd)):
        if t is not None:
            _check(t, name, torch.int32, (L, B))
    fc = _check_carry(fwd_carry, n_defs, B, ids.device)
    bc = _check_carry(bwd_carry, n_defs, B, ids.device)
    _check_window(p0, LS, L)
    CL = table_fsm_form(B, ids.device) if cl is None else cl
    if not 0 <= CL <= TABLE_FSM_CL:
        raise ValueError(f"chunk length {CL}: expected 0..{TABLE_FSM_CL}")
    if B == 0:
        return
    lib = build_tables()
    scratch = None
    if CL:
        scratch = torch.empty((2, -(-LS // CL), B), dtype=torch.int32, device=ids.device)
    elif bwd is not None and LS > TABLE_FSM_SMEM_LS:
        scratch = torch.empty((-(-LS // TABLE_FSM_CODE_SPAN), B), dtype=torch.int32,
                              device=ids.device)
    dirs = (fwd is not None) | (bwd is not None) << 1
    with torch.cuda.device(ids.device):
        _launch(TABLE_FSM, lib.h2r_table_fsm, dirs, ids.data_ptr(), start.data_ptr(),
                endf.data_ptr(), *map(_ptr, fc[:3]), fc[3], *map(_ptr, bc[:3]), bc[3],
                _ptr(fwd), _ptr(bwd), _ptr(scratch), n_defs, B, L, p0, LS, CL, _stream(ids),
                n=3 if CL else 1)


def table_fsm_cuda(reverse: bool, ids, start, endf, entry, carry_ids, carry_x,
                   p0: int, LS: int, out, cl: Optional[int] = None) -> None:
    """One mask FSM (``table_fsms_cuda``): same contract as
    ``pallas_scan.fsm_plain``."""
    kw = {"bwd" if reverse else "fwd": out,
          "bwd_carry" if reverse else "fwd_carry": (entry, carry_ids, carry_x)}
    table_fsms_cuda(ids, start, endf, p0, LS, cl=cl, **kw)


def table_flat_cuda(cmap, table, first, chars, lengths, states, ids, start, endf,
                    fwd, bwd, bits=None, table_in_smem: Optional[bool] = None) -> None:
    """B12 (``csrc/table_flat.cu``): same contract as
    ``pallas_scan.flat_plain``, one launch for the whole call (a model of
    more than ``FLAT_GROUP_DEFS`` defs is scanned in groups inside it).
    ``bits``: the backward pass's bit words [3, ceil(L / 32), B] int32
    (``pallas_scan.flat_bits_plain``'s), a new scratch when not given.
    ``table_in_smem``: False reads the table from global memory even where
    it fits shared memory; ``None`` is ``flat_smem_bytes``' choice."""
    n_defs, K, S = table.shape
    B, L = chars.shape
    _check(cmap, "cmap", torch.int32, (n_defs, 256))
    _check(table, "table", torch.int32, (n_defs, K, S))
    _check(first, "first", torch.int32, (n_defs,))
    _check(chars, "chars", torch.uint8, (B, L))
    _check(lengths, "lengths", torch.int32, (B,))
    for name, t in (("states", states), ("ids", ids), ("start", start), ("endf", endf)):
        _check(t, name, torch.int32, (n_defs, L, B))
    _check(fwd, "fwd", torch.int32, (L, B))
    _check(bwd, "bwd", torch.int32, (L, B))
    if bits is None:
        bits = torch.empty((3, -(-L // 32), B), dtype=torch.int32, device=chars.device)
    _check(bits, "bits", torch.int32, (3, -(-L // 32), B))
    if B == 0 or L == 0:
        return
    lib = build_tables()
    smem = flat_smem_bytes(n_defs, K, S, _smem_optin(chars.device))
    if table_in_smem is False:
        smem = 0
    elif table_in_smem and not smem:
        raise ValueError(f"table {(n_defs, K, S)} does not fit shared memory")
    vec = int(L % 16 == 0 and chars.data_ptr() % 16 == 0)  # 16-byte char loads
    with torch.cuda.device(chars.device):
        _launch(TABLE_FLAT, lib.h2r_table_flat, chars.data_ptr(), lengths.data_ptr(),
                cmap.data_ptr(), table.data_ptr(), first.data_ptr(), states.data_ptr(),
                ids.data_ptr(), start.data_ptr(), endf.data_ptr(), fwd.data_ptr(),
                bwd.data_ptr(), bits.data_ptr(), n_defs, B, L, K, S, vec, smem, _stream(chars))
