"""Time the port's redesigned kernels against an earlier version of the
package, on one NVIDIA GPU.

    git archive <commit> halo2_regex_tpu_torch | tar -x -C build/ab_old
    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch

``--old`` is a directory holding the earlier ``halo2_regex_tpu_torch/``,
imported as ``h2r_old``: its own kernels module builds its ``csrc/`` by
the same nvcc route into the same build root.  Every pair runs on the
same inputs, is checked equal (and equal to the plain version), and is
timed in turns, old, new, new, old (CUDA events, the L2 flushed by a
write, ``profiling.L2Flush(write=True)``, unless a line says a reading
flush; chip_smoke's ``time_ms``: device-only windows for kernels, a
caller's window for walls).

Kernels, on the zk-email ``from:`` model with bench.py's corpus, at
B=32768 and at B=4096 (its first strings):
  pack_raw  B5 (``csrc/bitplane_pack_words.cuh``) at L=1000 (L_pad 1024,
            the L1000 path) in each mode: binary and one-hot class
            planes, class stage off, en_pack off; binary with qpack=False
            at L=1024;
  tpack     B6 (the same kernel, tiled strides) on ``tile_corpus`` output
            at L=1024 in its three class-stage modes;
  fb_only   B4 (``csrc/bitplane_fb.cu``) on the match path's log and
            enable planes at L=1024, and at L=1000 (the log planes of
            the L1000 path);
and each new kernel against its variants (``PACK_VARIANTS``,
``FB_VARIANTS``: copies of ``csrc/`` with one edit; those in
``TIMING_ONLY`` compute something else and are timed, not checked), and
without the L2 flush.
ptxas' registers, shared memory and spills, and the SASS instruction
counts, of both kernels, old and new.

Walls, old package against new, with equal outputs, 30 runs each, at
B=32768 and B=4096: match, tiled_match, tiled_witness, L1000 witness
(pack_raw) and witness (no kernel of this PR on its path).

marker (``--old`` optional): the marker-stream probe kernel
(``csrc/probe_marker.cu``, chunked form) against the old package's and
its variants (``MARKER_VARIANTS``) at each chunk length, on the probes'
corpus at B=32768 and B=4096 x L=1024, in turns (kernel, variant,
variant, kernel); beside them the stack's ``clone`` and the kernel after
a flush that reads (``ReadFlush``: clean lines in L2):

    python3 kernel_ab.py --only marker

lookup (needs ``--old``): dfa_step's lookup (``csrc/probe_dfa_step.cu``)
at the from: batch and k7, old against new and against
``LOOKUP_VARIANTS``, and after a reading flush.

wide (``--old`` optional): the widened DFA step ``dfa_wide``
(``csrc/probe_dfa_wide.cu``) at configs[3] (B=64 x L=65536, its 96 x
1008 table split hi/lo) and at v2's [4096, 128]: both forms against the
old package's (old, new, new, old), the lookup beside B8's table scan at
configs[3] (in turns), the product against ``wide_variants`` (clusters of
8, the exchange by weak tagged stores; ``no_products`` and
``no_exchange`` timed only) and the lookup in
other forms, all checked (``LOOKUP_FORMS``: serial, W = 4096, C = 256
and 1024), each after the write flush and after a reading flush:

    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch --only wide

units (needs ``--old``): the compare-rate probe ``onehot_count``
(``csrc/probe_units.cu``) at [1024, 512], the accumulate probe
``mma_accum`` (``csrc/probe_mma_accum.cu``) at [4, 2, 128, 128] and
[4, 8, 1024, 1024], the int8 product ``int8_mma``
(``csrc/probe_int8_mma.cu``) at 128^3 (the probe's ranges) and 4096^3
(the whole int8 range), and the DFA step's product forms ``dfa_step``
(``csrc/probe_dfa_step.cu``: onehot_mma and class_mma, both picks) on
the from: batch (32768 x 1024, time-major) and at the probes' own widths
(k6, C, D, fullwidth, select), the old package's forms
against the new (old, new, new, old), the library call against the
kernel (kernel, library, library, kernel; the range test,
``torch.matmul(a, b).float().cumsum(1)``, ``torch._int_mm``) and each of
``COUNT_VARIANTS``, ``MMA_VARIANTS``, ``INT8_VARIANTS`` and
``DFA_VARIANTS`` against the kernel:

    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch --only units

scan (``--old`` optional): the chunked ``loop_floor`` and slab kernels
(``csrc/probe_tpu9.cu``, ``csrc/probe_slab.cuh``) at chip_smoke's [10] and
[11] widths and probe_tpu6's k1 and k3 against the ``--old`` package's
(its serial kernels; old, new, new, old, after the write flush and
after a reading flush), against their serial forms and against
``scan_variants`` (C = 64, 128, 256, 512; n_sub, two launches, one tile a
look-back round, wide maps, no early end states; no_compute, no_store and
no_lookback timed only), and B8's speculation and repair in place of the maps on the
probe's table and on a permutation table:

    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch --only scan

bitop (``--old`` optional): bitop_scan's table form (``csrc/probe_tpu20.cu``)
at [1024, 12, 8, 128] against the ``--old`` package's serial kernel at each
n_ops (old, new, new, old, after the write flush and after a reading
flush), against its own serial form, and against ``BITOP_VARIANTS`` (the
split table, per-bit extraction of the index; ``no_chain`` timed only) at
n_ops 96 and 768; the table's build at each n_ops; chains' fixed form
(``csrc/probe_tpu56.cu``) against its serial form and the ``--old``
package's at C = 1, 2, 4 in both geometries; ptxas and the SASS of the
new kernels:

    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch --only bitop

carry (``--old`` optional): bitop_carry's reduce form (``csrc/probe_tpu20.cu``)
at [2, 1024, 1, 8, 128] (one read a chunk, every position) and at [2, 8192,
1, 8, 128] (every position, 64 MiB) against the ``--old`` package's serial
kernel (old, new, new, old, after the write flush and after a reading
flush), its own serial form, an int64 sum of the same words and its
variants (4-byte loads only, the loads by ``__ldg``, the other combine: the
last block of a tile folding the partials from global memory; half the
blocks and every other cluster size; no_sync and no_load timed only), with
its geometry and bytes bound:

    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch --only carry

gather (``--old`` optional): lane_gather's pow form (``csrc/probe_gather.cu``)
at 1024 steps on [256, 128], [1, 128] and probe_tpu3's loop, both stores,
against the ``--old`` package's serial chain, its own serial form and eight
rows a block:

    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch --only gather

The record goes to ``chiprun_out/kernel_ab.json``; the last line is a
JSON summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WALL_ITERS = 30  # the walls move with the host: more runs than a kernel's 10
PACK_MODES = {"binary": {}, "onehot": dict(class_stage="onehot"),
              "off": dict(class_stage=False), "en_off": dict(en_pack=False)}
SIZES = (32768, 4096)  # the headline batch and the latency rows' (chip_smoke B_LATENCY)


def import_old(old_pkg: Path):
    """The earlier package at ``old_pkg``, imported as ``h2r_old`` (its
    imports are relative, so it loads beside the checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "h2r_old", old_pkg / "__init__.py", submodule_search_locations=[str(old_pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["h2r_old"] = mod
    spec.loader.exec_module(mod)
    return mod, importlib.import_module("h2r_old.ops.kernels")


def in_turns(cs, name, run_old, run_new, flush, card, device_only=True, iters=10) -> dict:
    """old, new, new, old, ``iters`` runs each; prints and returns the
    medians and every run."""
    t = [cs.time_ms(f, flush, device_only=device_only, iters=iters)
         for f in (run_old, run_new, run_new, run_old)]
    print(f"{name}: old {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, new "
          f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms (old, new, new, old; outputs equal); "
          f"card {card}", flush=True)
    return {"old": [t[0]["median"], t[3]["median"]], "new": [t[1]["median"], t[2]["median"]],
            "iqr": [x["iqr"] for x in t], "runs": [x["all"] for x in t]}


def probes_key(K) -> str:
    """The build-log key of ``K``'s probes library (built here if need be)."""
    return Path(K.build_probes()._name).parent.name


def ptxas_of(K, keys, kernel: str) -> list:
    """ptxas' lines for the entries whose mangled name holds ``kernel`` in
    the libraries ``keys`` (the build log kept beside each): registers,
    smem, spills."""
    out = []
    for key in keys:
        lines = (K.build_root() / key / "build.log").read_text().splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and kernel in ln:
                out.append(" | ".join(x.strip() for x in lines[i: i + 4]))
    return out


class Pkgs:
    """The new and the old package's modules, side by side."""

    def __init__(self, h2r, old, K, old_k):
        self.h2r, self.old, self.K, self.old_k = h2r, old, K, old_k
        self.bp = importlib.import_module("halo2_regex_tpu_torch.ops.bitplane")
        self.knobs = importlib.import_module("halo2_regex_tpu_torch.ops.knobs")
        self.obp = importlib.import_module("h2r_old.ops.bitplane")
        self.oknobs = importlib.import_module("h2r_old.ops.knobs")

    def plans(self, L, tiled=False, columns="witness", **kw):
        """(old plan, new plan) of the from: model's ``columns`` path."""
        out = []
        for pkg, bp, kn in ((self.old, self.obp, self.oknobs), (self.h2r, self.bp, self.knobs)):
            model = pkg.zoo.email_headers_model(max_chars_size=L, headers=("from",))
            out.append(bp.make_plan(model, columns, knobs=kn.BitplaneKnobs.from_env(**kw),
                                    tiled=tiled))
        return tuple(out)


def check(cs, name, got, want):
    torch.cuda.synchronize()
    if cs.max_abs_err(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")


def variant_csrc(K, name: str, edits) -> Path:
    """A copy of ``csrc/`` under the build root with ``edits`` (file, text,
    replacement) applied; each text must be there."""
    var_dir = K.build_root().parent / f"ab_{name}" / "csrc"
    if var_dir.exists():
        shutil.rmtree(var_dir)
    shutil.copytree(K.CSRC, var_dir)
    for fname, old, new in edits:
        text = (var_dir / fname).read_text()
        if old not in text:
            raise AssertionError(f"variant {name}: no {old!r} in csrc/{fname}")
        (var_dir / fname).write_text(text.replace(old, new))
    return var_dir


# the quad-word pack's variants: the tile's copies in one commit group and
# in four (the kernel: two); three and two blocks an SM asked of the
# register allocator; position tiles varying fastest in the grid; and, for
# timing only (their outputs are not the pack's), the kernel without its
# copies of the quads and without its bit work
PACK_VARIANTS = {
    "one_group": [("bitplane_pack_words.cuh", "constexpr int kPwGroups = 2;",
                   "constexpr int kPwGroups = 1;")],
    "four_groups": [("bitplane_pack_words.cuh", "constexpr int kPwGroups = 2;",
                     "constexpr int kPwGroups = 4;")],
    "lb3": [("bitplane_pack_words.cuh", "__launch_bounds__(kPwThreads, 4)",
             "__launch_bounds__(kPwThreads, 3)")],
    "lb2": [("bitplane_pack_words.cuh", "__launch_bounds__(kPwThreads, 4)",
             "__launch_bounds__(kPwThreads, 2)")],
    "positions_first": [
        ("bitplane_pack_words.cuh", "const int w0 = blockIdx.x * kPwTW, l0 = blockIdx.y * kPwTP;",
         "const int w0 = blockIdx.y * kPwTW, l0 = blockIdx.x * kPwTP;"),
        ("bitplane_pack_words.cuh", "const dim3 grid(NW / kPwTW, (L + kPwTP - 1) / kPwTP);",
         "const dim3 grid((L + kPwTP - 1) / kPwTP, NW / kPwTW);")],
    "no_load": [("bitplane_pack_words.cuh",
                 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst), '
                 '"l"(src) : "memory");',
                 "(void)dst;")],
    "no_compute": [("bitplane_pack_words.cuh",
                    "      h2r_byte_planes(q, bb);\n      uint32_t cls[H2R_KP];\n"
                    "      h2r_class(bb, cls);",
                    "      uint32_t cls[H2R_KP];\n#pragma unroll\n"
                    "      for (int i = 0; i < H2R_KP; ++i) cls[i] = q[i % 8];")],
}
# fb_only's variants: eight positions a thread (half the blocks), also at
# four blocks an SM (one wave at B=32768); no cluster, one block over all
# of L for its 8 words
FB_VARIANTS = {
    "per8": [("bitplane_fb.cu", "constexpr int kPer = 4;", "constexpr int kPer = 8;")],
    "per8_lb4": [("bitplane_fb.cu", "constexpr int kPer = 4;", "constexpr int kPer = 8;"),
                 ("bitplane_fb.cu", "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 4)")],
    "no_cluster": [("bitplane_fb.cu", "const int cs = min(kMaxCluster, (L + kStep - 1) / kStep);",
                    "const int cs = 1;")],
}
# marker_match's variants (csrc/probe_marker.cu, the chunked form):
# clusters of at most 8 blocks (the portable size: two rounds a block at
# L=1024); the TMA boxes
# issued in window order (the kernel: the warps' first boxes first); and,
# for timing only, the kernel without its loads
# (no boxes issued, no waits: the tile's stale words walked) and without
# its program (an XOR of the words)
MARKER_VARIANTS = {
    "cluster8": [("probe_marker.cu", "constexpr int kMaxCluster = 16;",
                  "constexpr int kMaxCluster = 8;")],
    "boxes_in_order": [("probe_marker.cu",
                        "      for (int j = 0; j < C / kPiece + 2; ++j)\n"
                        "        for (int v = 0; v < W; ++v) {\n"
                        "          const int q = v * C / kPiece + j;\n"
                        "          if (j >= C / kPiece && v < W - 1) continue;  // warp v + 1's box",
                        "      for (int q = 0; q < n_pieces; ++q) {")],
    "no_load": [("probe_marker.cu", "            hopper::tma_load_3d(tile + q * kPieceBytes,",
                 "            if (L < 0) hopper::tma_load_3d(tile + q * kPieceBytes,"),
                ("probe_marker.cu", "        hopper::mbar_wait(&bar[q], rd & 1);",
                 "        if (L < 0) hopper::mbar_wait(&bar[q], rd & 1);")],
    "no_sync": [("probe_marker.cu",
                 "  cluster.sync();  // every rank is done with its tile (rank 0's takes the summaries)",
                 "")],
    "no_compute": [("probe_marker.cu",
                    "__device__ __forceinline__ void step(Walk& s, const uint32_t* p, bool first) {\n",
                    "__device__ __forceinline__ void step(Walk& s, const uint32_t* p, bool first) {\n"
                    "  if (true) {\n    uint32_t x = first;\n"
                    "    for (int j = 0; j < kPlanes; ++j) x ^= p[j];\n    s.o0 ^= x;\n"
                    "    return;\n  }\n")],
}
TIMING_ONLY = ("no_load", "no_compute", "no_store", "no_stage", "class_half_products",
               "class_no_products", "no_fill", "no_chain", "no_sync", "no_products",
               "no_exchange", "no_lookback", "no_transpose", "no_ballot", "chain_only")
# onehot_count's variants (csrc/probe_units.cu), code that each inserts:
# - int: the compares on the int pipe (ISETP and a sum) against int keys;
# - atomic: the partials by atomics after a zero fill (cudaMemsetAsync) in
#   place of the cluster's shared memory, the same 16 blocks of rows;
# - int_sums: HSET2's 1.0s summed as integers (IADD3, on the int pipe:
#   at most one key matches a byte, so each half's sum stays under 2^16)
#   in place of HADD2, beside the compares on the fp16 pipe;
# - rows8, rows2: eight bytes a thread in blocks of eight warps; two bytes;
# - cluster8: clusters of up to 8 blocks (the portable size);
# - spread: one block an SM (120 KiB of shared memory asked for, unused),
#   so that a cluster's blocks do not share SMs;
# - timing only: no_compute (no compares: the launch, the loads and the
#   reduction)
_COUNT_BODY = """    uint32_t h[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = i0 + r * kCountWarps + w;
      const __half x = __int2half_rn(col && row < LB ? __ldg(c + (size_t)row * TB + j) : -1);
      h[r] = half2_bits(__halves2half2(x, x));
      acc[r] = 0;
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const uint4 k = lds128(&keys[4 * q]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = count2(acc[r], h[r], k.x);
        acc[r] = count2(acc[r], h[r], k.y);
        acc[r] = count2(acc[r], h[r], k.z);
        acc[r] = count2(acc[r], h[r], k.w);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) total += count_of(acc[r]);
"""
_COUNT_INT_BODY = """    int v[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = i0 + r * kCountWarps + w;
      v[r] = col && row < LB ? __ldg(c + (size_t)row * TB + j) : -1;
      acc[r] = 0;
    }
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      const uint4 k = lds128(&keys[4 * q]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] += (v[r] == (int)k.x) + (v[r] == (int)k.y) + (v[r] == (int)k.z) +
                  (v[r] == (int)k.w);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) total += acc[r];
"""
_COUNT_CLUSTER_TAIL = """  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");  // every rank has started
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < 32) cluster.map_shared_rank(&parts[0][0], 0)[rank * 32 + tid] = sum;
  cluster.sync();  // every rank's partial is in rank 0's memory
  if (rank == 0 && tid < 32 && col) {
    int all = 0;
#pragma unroll
    for (int r = 0; r < kCountCluster; ++r)
      if (r < split) all += parts[r][tid];
    o[j] = all;
  }
"""
_COUNT_CLUSTER_LAUNCH = """  if (kCountCluster > 8) {  // past the portable cluster size
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
"""
_COUNT_ATOMIC_LAUNCH = """  {
    const cudaError_t e = cudaMemsetAsync(o, 0, (size_t)TB * 4, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(TB + 31) / 32 * split, kCountWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)c, (int32_t*)o, LB, TB, split);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
"""
_U = "probe_units.cu"
COUNT_VARIANTS = {
    "int": [(_U, "__shared__ __align__(16) uint32_t keys[128];  // half2 (2k, 2k + 1)",
             "__shared__ __align__(16) uint32_t keys[256];"),
            (_U, "  for (int k = tid; k < 128; k += kCountWarps * 32)\n"
                 "    keys[k] = half2_bits(__halves2half2(__int2half_rn(2 * k), "
                 "__int2half_rn(2 * k + 1)));",
             "  for (int k = tid; k < 256; k += kCountWarps * 32) keys[k] = k;"),
            (_U, _COUNT_BODY, _COUNT_INT_BODY)],
    "atomic": [(_U, '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n',
                ""),
               (_U, _COUNT_CLUSTER_TAIL, "  if (tid < 32 && col) atomicAdd(&o[j], sum);\n"),
               (_U, _COUNT_CLUSTER_LAUNCH, _COUNT_ATOMIC_LAUNCH)],
    "int_sums": [(_U, '  asm("add.rn.f16x2 %0, %1, %2;\\n" : "=r"(acc) : "r"(acc), "r"(e));',
                  "  acc += e;"),
                 (_U, "  const float2 f = __half22float2(*(__half2*)&acc);\n"
                      "  return (int)(f.x + f.y);",
                  "  return (int)((acc & 0xffffu) / 0x3c00u + (acc >> 16) / 0x3c00u);")],
    "rows8": [(_U, "constexpr int kCountWarps = 16;", "constexpr int kCountWarps = 8;"),
              (_U, "constexpr int kCountRows = 4;", "constexpr int kCountRows = 8;")],
    "rows2": [(_U, "constexpr int kCountRows = 4;", "constexpr int kCountRows = 2;")],
    "cluster8": [(_U, "constexpr int kCountCluster = 16;", "constexpr int kCountCluster = 8;")],
    "spread": [(_U, "  cfg.stream = (cudaStream_t)stream;\n  cudaLaunchAttribute",
                "  cfg.stream = (cudaStream_t)stream;\n"
                "  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,"
                " 120 * 1024);\n  cfg.dynamicSmemBytes = 120 * 1024;\n  cudaLaunchAttribute")],
    "no_compute": [(_U, "    for (int q = 0; q < 32; ++q) {\n      const uint4 k = lds128(&keys[4 * q]);",
                    "    for (int q = 0; q < 0; ++q) {\n      const uint4 k = lds128(&keys[4 * q]);")],
}
# mma_accum's variants (csrc/probe_mma_accum.cu): a ring of three stages
# at 128 columns; 128 x 128 tiles for every N (128 x 256 is taken where N
# > 128); each l's sum stored from the registers (float2 stores, the TMA
# store rounds run none) in place of TMA stores; and, for timing only, no
# stores at all
_M = "probe_mma_accum.cu"
_MMA_DIRECT_STORE = """    {
      float* C = c + (size_t)z * M * N;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * w + g + 8 * h, col = n0 + 8 * j + 2 * q;
          if (row < M && col < N)
            *(float2*)&C[(size_t)row * N + col] =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
#pragma unroll
    for (int c0 = 0; c0 < 0; c0 += kOutCols) {
"""
MMA_VARIANTS = {
    "stages3": [(_M, "kStages = BN == 128 ? 4 : 3;", "kStages = 3;")],
    "bn128": [(_M, "const bool wide = N > 128;", "const bool wide = false;")],
    "direct_store": [
        (_M, "const __grid_constant__ CUtensorMap mo, int NL, int M, int N, int K) {",
         "const __grid_constant__ CUtensorMap mo, int NL, int M, int N, int K,\n"
         "                     float* __restrict__ c) {"),
        (_M, "int M, int N, int K, cudaStream_t stream) {",
         "int M, int N, int K, cudaStream_t stream, void* c) {"),
        (_M, "(ma, mb, mo, NL, M, N, K);", "(ma, mb, mo, NL, M, N, K, (float*)c);"),
        (_M, "K, (cudaStream_t)stream)", "K, (cudaStream_t)stream, c)"),
        (_M, "#pragma unroll\n    for (int c0 = 0; c0 < kBN; c0 += kOutCols) {"
             "  // one round unless kBN is 256\n", _MMA_DIRECT_STORE)],
    "no_store": [(_M, "if (t == 0 && r0 < M) {", "if (t == 0 && r0 < 0) {")],
}
# int8_mma's variants (csrc/probe_int8_mma.cu): one block a tile in place
# of the persistent grid (a tile's epilogue then overlaps nothing of its
# block's); the product kernel launched after the staging pass ends (no
# programmatic dependent launch); and, for timing only, the product
# kernel without the staging
# pass before it (it multiplies whatever the fresh scratch holds): the
# most that transposing b inside the product kernel could save
_I8 = "probe_int8_mma.cu"
INT8_VARIANTS = {
    "tile_a_block": [(_I8, "const int grid = (int)(tiles < sms ? tiles : sms);",
                      "const int grid = (int)tiles;")],
    "no_pdl": [(_I8, "programmaticStreamSerializationAllowed = 1;",
                "programmaticStreamSerializationAllowed = 0;")],
    "no_stage": [(_I8, "  int8_stage_kernel<<<(unsigned)(tb + ta), 256, 0, st>>>(",
                  "  if (tb < 0) int8_stage_kernel<<<(unsigned)(tb + ta), 256, 0, st>>>(")],
}
# dfa_step's variants (csrc/probe_dfa_step.cu), for the product forms: each
# step waits for its own products before its pick (no overlap of a pick
# with the next products inside a warpgroup); one warpgroup a block (its
# table and rings then leave one warpgroup an SM where the table is T's 64
# KiB); for class_mma, the class products as two or four independent
# chains of k16 slices (the kernel: one), added before the last product;
# and, for timing only, class_mma with 8 of its 16 class products, or none
# (the final product then reads stale class sums)
_D = "probe_dfa_step.cu"
_CLASS_WGMMA = "        else\n          hopper::wgmma_m64n16k16_f16_rs("


def _class_chains(n: int) -> list:
    """The edits that give class_mma ``n`` chains: kacc and n - 1 more
    sums (kx), slice kt into chain kt % n, their total converted."""
    return [
        (_D, "float acc[2][NS / 2], kacc[KC / 2];",
         f"float acc[2][NS / 2], kacc[KC / 2], kx[{n - 1}][KC / 2];"),
        (_D, "    for (int e = 0; e < KC / 2; ++e) kacc[e] = 0.f;\n",
         f"    for (int e = 0; e < KC / 2; ++e) {{\n      kacc[e] = 0.f;\n"
         f"#pragma unroll\n      for (int c = 0; c < {n - 1}; ++c) kx[c][e] = 0.f;\n    }}\n"),
        (_D, "              kacc, a[kt], hopper::sw128_desc(tab + hopper::sw128_kmajor(0, 16 * kt, "
             "KC), 16, 1024),\n              kt > 0);",
         f"              kt % {n} ? kx[kt % {n} - 1] : kacc, a[kt],\n"
         f"              hopper::sw128_desc(tab + hopper::sw128_kmajor(0, 16 * kt, KC), 16, 1024),"
         f"\n              kt >= {n});"),
        (_D, "ak[r] = h2_bits(__floats2half2_rn(kacc[2 * r], kacc[2 * r + 1]));",
         f"{{\n        float lo = kacc[2 * r], hi = kacc[2 * r + 1];\n"
         f"#pragma unroll\n        for (int c = 0; c < {n - 1}; ++c)\n"
         f"          lo += kx[c][2 * r], hi += kx[c][2 * r + 1];\n"
         f"        ak[r] = h2_bits(__floats2half2_rn(lo, hi));\n      }}"),
        (_D, "        for (int e = 0; e < KC / 2; ++e) hopper::fence_operand(kacc[e]);\n",
         f"        for (int e = 0; e < KC / 2; ++e) {{\n          hopper::fence_operand(kacc[e]);\n"
         f"#pragma unroll\n          for (int c = 0; c < {n - 1}; ++c)\n"
         f"            hopper::fence_operand(kx[c][e]);\n"
         f"        }}\n")]


DFA_VARIANTS = {
    "no_overlap": [(_D, "      if (t >= LAG && t - LAG < LB) pick_step(",
                    "      hopper::wgmma_wait<0>();\n"
                    "      if (t >= LAG && t - LAG < LB) pick_step(")],
    "one_warpgroup": [(_D, "constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "class_chains2": _class_chains(2),
    "class_chains4": _class_chains(4),
    "class_half_products": [(_D, _CLASS_WGMMA, _CLASS_WGMMA.replace("else", "else if (kt < 8)"))],
    "class_no_products": [(_D, _CLASS_WGMMA, _CLASS_WGMMA.replace("else", "else if (kt < 0)"))],
}
# the lookup's variants (csrc/probe_dfa_step.cu, dfa_lookup_kernel): a ring
# of 3 groups (the kernel: 5); at most 4 warps a block (the kernel: 8, 6
# batch-major);
# and, for timing only, T's copies skipped (the state masked to 7 bits so
# that the stale table's lookups stay in it: one more op on the chain), the
# bytes' copies skipped (the ring's stale words walked), the states' stores
# skipped, and the lookup replaced by its address (no LDS on the chain)
LOOKUP_VARIANTS = {
    "ring3": [(_D, "constexpr int kLkRing = 5;", "constexpr int kLkRing = 3;")],
    "warps4": [(_D, "constexpr int kLkWarps = 8;", "constexpr int kLkWarps = 4;")],
    "no_fill": [(_D, "        hopper::bulk_load(", "        if (TB < 0) hopper::bulk_load("),
                (_D, "  if (vec_t) hopper::mbar_wait(bar, 0);", ""),
                (_D, "          s = lds(row + ((uint32_t)s << 2));",
                 "          s = lds(row + ((uint32_t)s << 2)) & 127;")],
    "no_load": [(_D, "          if (b < TB && i < LB) cp16(dst, src);",
                 "          if (TB < 0) cp16(dst, src);")],
    "no_store": [(_D, "        if (b < TB && i < LB) *(int4*)dst = v;",
                  "        if (TB < 0) *(int4*)dst = v;")],
    "no_chain": [(_D, "          s = lds(row + ((uint32_t)s << 2));",
                  "          s = (int)((row + ((uint32_t)s << 2)) & 0x1fffcu);")],
}


# dfa_wide's product variants (csrc/probe_dfa_wide.cu, wide_mma_kernel):
# clusters of at most 8 ranks (two n tiles a rank at configs[3]); and, for
# timing only, no products issued (the picks read stale sums) and no
# exchange (no words sent, no waits for them: each rank reads its own
# stale slots)
_W = "probe_dfa_wide.cu"
WIDE_VARIANTS = {
    "cluster8": [(_W, "constexpr int kMaxCluster = 16;", "constexpr int kMaxCluster = 8;")],
    "no_products": [(_W, "        hopper::wgmma_m64n128k16_f16_rs(",
                     "        if (L < 0) hopper::wgmma_m64n128k16_f16_rs(")],
    "no_exchange": [(_W, "        st_async4(xr[i]", "        if (L < 0) st_async4(xr[i]"),
                    (_W, "    if (lane == 0) hopper::mbar_expect_tx(",
                     "    if (L < 0) hopper::mbar_expect_tx("),
                    (_W, "    warp_wait(&mbar[q * 4 + w], (t / kSlots) & 1);", "")],
}
# and the exchange as weak 16-byte remote stores of (word, tag) pairs,
# polled by volatile loads, no mbarrier (checked: the same states)
_WEAK_SEND = (
    "    const uint32_t tag = (uint32_t)(t / kSlots) + 1;\n#pragma unroll\n"
    "    for (int i = 0; i < kMaxCluster / 4; ++i)\n      if (tig + 4 * i < R)\n"
    "        asm volatile(\"st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\\n\" ::\"r\"(\n"
    "                         xr[i] + q * (kMaxCluster * 4 * 32 * 4)),\n"
    "                     \"r\"(w0), \"r\"(tag), \"r\"(w1), \"r\"(tag)\n                     : \"memory\");")
_WEAK_RECV = (
    "    uint32_t s0 = 0, s1 = 0;\n    {\n"
    "      const uint32_t base = hopper::smem_u32(xbuf + (q * kMaxCluster * 4 + w) * 32 + "
    "4 * (lane & 7));\n"
    "      bool all = false;\n      while (!all) {\n        bool ok = true;\n"
    "        s0 = 0;\n        s1 = 0;\n#pragma unroll\n"
    "        for (int i = 0; i < kMaxCluster / 4; ++i) {\n"
    "          const int r = (lane >> 3) * (kMaxCluster / 4) + i;\n"
    "          uint32_t a0, t0, a1, t1;\n"
    "          asm volatile(\"ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\\n\"\n"
    "                       : \"=r\"(a0), \"=r\"(t0), \"=r\"(a1), \"=r\"(t1)\n"
    "                       : \"r\"(base + (uint32_t)r * (4 * 32 * 4))\n"
    "                       : \"memory\");\n"
    "          s0 += r < R ? a0 : 0u;\n          s1 += r < R ? a1 : 0u;\n"
    "          ok = ok && (r >= R || (t0 == tag && t1 == tag));\n        }\n"
    "        all = __all_sync(0xffffffffu, ok);\n      }\n"
    "      s0 += __shfl_xor_sync(0xffffffffu, s0, 8);\n"
    "      s0 += __shfl_xor_sync(0xffffffffu, s0, 16);\n"
    "      s1 += __shfl_xor_sync(0xffffffffu, s1, 8);\n"
    "      s1 += __shfl_xor_sync(0xffffffffu, s1, 16);\n    }\n    int y[4];\n    {\n"
    "      const uint32_t v0 = __shfl_sync(0xffffffffu, s0, g), v1 = __shfl_sync(0xffffffffu, s1, g);\n"
    "      y[0] = (int)(v0 & 0xFFFF);\n      y[1] = (int)(v0 >> 16);\n"
    "      y[2] = (int)(v1 & 0xFFFF);\n      y[3] = (int)(v1 >> 16);\n    }")


def _block(text: str, first: str, last: str) -> str:
    """The lines of ``text`` from the one holding ``first`` to the one ending ``last``."""
    i = text.index(first)
    return text[i: text.index(last, i) + len(last)]


def wide_variants(K) -> dict:
    """``WIDE_VARIANTS`` and ``weak_tagged``, whose edits replace blocks of
    the source as it is."""
    src = (K.CSRC / _W).read_text()
    send = _block(src, "    const uint32_t msg[4] = {w0, w1,",
                  "st_async4(xr[i] + q * (kMaxCluster * kStrings * 4), msg, mr[i] + q * 32);")
    recv = _block(src, "    warp_wait(&mbar[q * 4 + w], (t / kSlots) & 1);",
                  "      y[2 * h + 1] = (int)(v >> 16);\n    }")
    return {**WIDE_VARIANTS, "weak_tagged": [
        (_W, "constexpr int kXbufWords = kSlots * kMaxCluster * kStrings;",
         "constexpr int kXbufWords = kSlots * kMaxCluster * 4 * 32;"),
        (_W, "    xr[i] = map_rank(hopper::smem_u32(xbuf + (rank * 4 + w) * 16 + 2 * g), r);",
         "    xr[i] = map_rank(hopper::smem_u32(xbuf + (rank * 4 + w) * 32 + 4 * g), r);"),
        (_W, "  if (tid < kSlots * 4) hopper::mbar_init(&mbar[tid], 1);",
         "  for (int u = tid; u < kXbufWords; u += 128) xbuf[u] = 0;\n"
         "  if (tid < kSlots * 4) hopper::mbar_init(&mbar[tid], 1);"),
        (_W, send, _WEAK_SEND), (_W, recv, _WEAK_RECV)]}


# the lookup's other forms, (C, W) of its chunks: (0, 0) the serial form
LOOKUP_FORMS = {"serial": (0, 0), "W4096": (512, 4096), "C256": (256, 8192),
                "C1024": (1024, 8192)}

MEMORY_OPS = ("LDG", "STG", "LDGSTS", "UTMALDG", "UTMASTG", "LDS", "STS")


def sass_counts(K, keys, kernel: str) -> list:
    """The SASS instruction count of each entry whose name holds
    ``kernel`` in the libraries ``keys`` (cuobjdump), by opcode class;
    each library's SASS goes to ``chiprun_out/sass/<key>.sass``."""
    cuobjdump = Path(K._nvcc()).parent / "cuobjdump"
    out = []
    (ROOT / "chiprun_out" / "sass").mkdir(parents=True, exist_ok=True)
    for key in keys:
        so = K.build_root() / key / "libh2r.so"
        res = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True)
        (ROOT / "chiprun_out" / "sass" / f"{key}.sass").write_text(res.stdout)
        fn, ops, mem = None, {}, {}
        for ln in res.stdout.splitlines():
            if "Function :" in ln:
                if fn and kernel in fn:
                    out.append({"function": fn, "instructions": sum(ops.values()), "ops": ops,
                                "memory": mem})
                fn, ops, mem = ln.split("Function :", 1)[1].strip(), {}, {}
            elif fn and "/*" in ln and ";" in ln:
                ins = ln.split("*/", 1)[1].strip().split()
                if ins and ins[0].startswith("@"):
                    ins = ins[1:]
                if ins:
                    op = ins[0].split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
                    if op in MEMORY_OPS:  # with its modifiers: the access width
                        mem[ins[0]] = mem.get(ins[0], 0) + 1
        if fn and kernel in fn:
            out.append({"function": fn, "instructions": sum(ops.values()), "ops": ops,
                        "memory": mem})
    for r in out:
        top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:12]
        print(f"sass {r['function'][-60:]}: {r['instructions']} instructions; {top}; memory "
              f"{r['memory']}", flush=True)
    return out


def ReadFlush(flush):
    """The reading flush (``profiling.L2Flush``: clean lines in L2) on the
    buffer of ``flush``, the script's write flush."""
    from halo2_regex_tpu_torch.utils import profiling

    return profiling.L2Flush(buf=flush.buf)


def no_flush_ms(cs, fn, dev, name, card) -> float:
    """``fn``'s median device time with the L2 left as the last run left
    it (no flush before each run)."""
    t = cs.time_ms(fn, False, device_only=True)
    print(f"{name}, new, without the L2 flush: {cs.fmt(t)}; card {card}", flush=True)
    return t["median"]


def build_variants(K, plan, kernel, source, variants) -> dict:
    """Each variant's library (``source`` alone, for ``kernel``) of
    ``plan``'s generated header, built at once."""
    header = K.circuits_header(plan)
    dirs = {name: variant_csrc(K, f"{kernel.name}_{name}", edits)
            for name, edits in variants.items()}
    with ThreadPoolExecutor(len(dirs)) as pool:
        jobs = {name: pool.submit(K._build_library, (source,), (kernel,), K.HEADERS, header, d)
                for name, d in dirs.items()}
        return {name: j.result() for name, j in jobs.items()}


def pack_ab(pk: Pkgs, cs, dev, card, flush, corpora) -> dict:
    """pack_raw and tpack, old against new, in each mode at both batch
    sizes; the new kernel against its variants at B=32768."""
    K, old_k, bp = pk.K, pk.old_k, pk.bp
    cases = {}  # name -> (kernel, old plan, new plan, L)
    for mode, kw in PACK_MODES.items():
        cases[f"pack_raw {mode} L=1000"] = (K.PACK_RAW, *pk.plans(cs.L_UNPADDED, **kw),
                                            cs.L_UNPADDED)
    cases["pack_raw binary qpack=False L=1024"] = (K.PACK_RAW, *pk.plans(cs.L, qpack=False),
                                                   cs.L)
    for mode in ("binary", "onehot", "off"):
        cases[f"tpack {mode}"] = (K.TPACK, *pk.plans(cs.L, tiled=True, **PACK_MODES[mode]),
                                  cs.L)
    before, before_old = set(K.BUILD_LOG), set(old_k.BUILD_LOG)
    with ThreadPoolExecutor(12) as pool:
        for j in [pool.submit(k.build, p) for _k, po, pn, _L in cases.values()
                  for k, p in ((old_k, po), (K, pn))]:
            j.result()
    pn_raw = cases["pack_raw binary L=1000"][2]
    var_libs = build_variants(K, pn_raw, K.PACK_RAW, "bitplane_pack_raw.cu", PACK_VARIANTS)
    new_keys = sorted(set(K.BUILD_LOG) - before)
    rec = {"ptxas": ptxas_of(K, new_keys, "pack_words_kernel"),
           "ptxas_old": ptxas_of(old_k, sorted(set(old_k.BUILD_LOG) - before_old),
                                 "pack_words_kernel")}
    for ln in rec["ptxas"]:
        print(f"ptxas (pack_words): {ln}", flush=True)
    for ln in rec["ptxas_old"]:
        print(f"ptxas (pack_words, old): {ln}", flush=True)
    rec["sass"] = (sass_counts(K, new_keys, "pack_words_kernel")
                   + sass_counts(old_k, sorted(set(old_k.BUILD_LOG) - before_old),
                                 "pack_words_kernel"))
    for B in SIZES:
        chars_np, lengths_np = (a[:B] for a in corpora[cs.L])
        raw_np, raw_len = (a[:B] for a in corpora[cs.L_UNPADDED])
        ins = {}
        for Lc, (c_np, l_np) in ((cs.L, (chars_np, lengths_np)),
                                 (cs.L_UNPADDED, (raw_np, raw_len))):
            ch = torch.from_numpy(c_np).to(dev)
            ins[Lc] = (ch, bp.len_table(torch.from_numpy(l_np).to(dev)))
        tiled = torch.from_numpy(bp.tile_corpus(chars_np, cs.L)).to(dev)
        for name, (k, po, pn, Lc) in cases.items():
            ch, lw = ins[Lc]
            if k is K.TPACK:
                x = tiled
                want = bp.tpack_plain(pn, x, lw)

                def run_old(po=po, x=x, lw=lw):
                    return old_k.tpack_cuda(po, x, lw)

                def run_new(pn=pn, x=x, lw=lw):
                    return K.tpack_cuda(pn, x, lw)
            else:
                x = bp.raw_quads(ch, pn.L_pad)
                want = bp.pack_plain(pn, x, lw)

                def run_old(po=po, x=x, lw=lw):
                    return old_k.pack_raw_cuda(po, x, lw)

                def run_new(pn=pn, x=x, lw=lw):
                    return K.pack_raw_cuda(pn, x, lw)
            check(cs, f"{name} old", run_old(), want)
            check(cs, f"{name} new", run_new(), want)
            words = B // 32
            bound = cs.bound(cs.nbytes(x) + cs.nbytes(lw) * pn.en_pack
                             + pn.L_pad * words * 4 * (pn.kp + pn.en_pack),
                             sum(c.class_prog.n_ops for c in pn.circuits) * pn.L_pad * words
                             * bool(pn.class_stage))
            key = f"{name} B={B}"
            rec[key] = in_turns(cs, f"{key} (KP={pn.kp}; bound {bound['bound_ms']:.4f} ms by "
                                f"{bound['bound_by']})", run_old, run_new, flush, card)
            rec[key]["bound_ms"] = bound["bound_ms"]
            if name == "pack_raw binary L=1000":
                rec[f"{key} no_flush"] = no_flush_ms(cs, run_new, dev, key, card)
                for vname, lib in var_libs.items():
                    def run_var(lib=lib, x=x, lw=lw):
                        bits = torch.empty_like(want[0])
                        en = torch.empty_like(want[1])
                        err = lib.h2r_pack_raw(x.data_ptr(), lw.data_ptr(), bits.data_ptr(),
                                               en.data_ptr(), B // 32, pn.L_pad,
                                               torch.cuda.current_stream().cuda_stream)
                        assert err == 0, err
                        return bits, en
                    if vname not in TIMING_ONLY:
                        check(cs, f"pack_raw variant {vname}", run_var(), want)
                    rec[f"{key} {vname}"] = in_turns(
                        cs, f"{key}: the kernel as old, variant {vname} as new", run_new,
                        run_var, flush, card)
            del want
    return rec


def fb_ab(pk: Pkgs, cs, dev, card, flush, corpora) -> dict:
    """fb_only, old against new, on the match path's planes at both batch
    sizes (L=1024, and L=1000's L_pad 1024 with its shorter strings); the
    new kernel against its variants."""
    K, old_k, bp = pk.K, pk.old_k, pk.bp
    plans = {Lc: pk.plans(Lc, columns="match") for Lc in (cs.L, cs.L_UNPADDED)}
    before, before_old = set(K.BUILD_LOG), set(old_k.BUILD_LOG)
    with ThreadPoolExecutor(4) as pool:
        for j in [pool.submit(k.build, p) for po, pn in plans.values()
                  for k, p in ((old_k, po), (K, pn))]:
            j.result()
    var_libs = build_variants(K, plans[cs.L][1], K.FB_ONLY, "bitplane_fb.cu", FB_VARIANTS)
    new_keys = sorted(set(K.BUILD_LOG) - before)
    rec = {"ptxas": ptxas_of(K, new_keys, "fb_kernel"),
           "ptxas_old": ptxas_of(old_k, sorted(set(old_k.BUILD_LOG) - before_old), "fb_kernel")}
    for ln in rec["ptxas"] + rec["ptxas_old"]:
        print(f"ptxas (fb_kernel): {ln}", flush=True)
    rec["sass"] = (sass_counts(K, new_keys, "fb_kernel")
                   + sass_counts(old_k, sorted(set(old_k.BUILD_LOG) - before_old), "fb_kernel"))
    for B in SIZES:
        for Lc, (po, pn) in plans.items():
            c_np, l_np = (a[:B] for a in corpora[Lc])
            ch = torch.from_numpy(c_np).to(dev)
            lw = bp.len_table(torch.from_numpy(l_np).to(dev))
            bits, en = (bp.qpack(pn, ch, lw) if pn.qpack
                        else bp.pack(pn, bp.raw_quads(ch, pn.L_pad), lw))
            logs = K.scan_cuda(pn, bits)
            want = bp.fb_only_plain(pn, logs, en)

            def run_old(po=po, logs=logs, en=en):
                return old_k.fb_only_cuda(po, logs, en)

            def run_new(pn=pn, logs=logs, en=en):
                return K.fb_only_cuda(pn, logs, en)

            check(cs, f"fb_only L={Lc} old", run_old(), want)
            check(cs, f"fb_only L={Lc} new", run_new(), want)
            bound = cs.fb_bound(pn, en)
            key = f"fb_only L={Lc} B={B}"
            rec[key] = in_turns(cs, f"{key} (bound {bound['bound_ms']:.4f} ms by "
                                f"{bound['bound_by']})", run_old, run_new, flush, card)
            rec[key]["bound_ms"] = bound["bound_ms"]
            if Lc == cs.L:
                rec[f"{key} no_flush"] = no_flush_ms(cs, run_new, dev, key, card)
                for vname, lib in var_libs.items():
                    def run_var(lib=lib, logs=logs, en=en):
                        fb = torch.empty_like(want)
                        err = lib.h2r_fb_only(logs.data_ptr(), en.data_ptr(), fb.data_ptr(),
                                              B // 4096, Lc,
                                              torch.cuda.current_stream().cuda_stream)
                        assert err == 0, err
                        return fb
                    check(cs, f"fb_only variant {vname}", run_var(), want)
                    rec[f"{key} {vname}"] = in_turns(
                        cs, f"{key}: the kernel as old, variant {vname} as new", run_new,
                        run_var, flush, card)
            del want, bits, en, logs
    return rec


def walls_ab(pk: Pkgs, cs, dev, card, flush, corpora) -> dict:
    """End-to-end walls, old package against new, in turns, with equal
    outputs, at both batch sizes."""
    h2r, old, K, old_k = pk.h2r, pk.old, pk.K, pk.old_k

    def from_model(p, length=cs.L):
        return p.zoo.email_headers_model(max_chars_size=length, headers=("from",))

    paths = {
        "match": (lambda p: p.BitplaneMatcher(from_model(p), columns="match"), cs.L, False),
        "tiled_match": (lambda p: p.BitplaneMatcher(from_model(p), columns="match",
                                                    input_layout="tiled"), cs.L, True),
        "tiled_witness": (lambda p: p.BitplaneMatcher(from_model(p), columns="witness",
                                                      input_layout="tiled"), cs.L, True),
        "L1000": (lambda p: p.BitplaneMatcher(from_model(p, cs.L_UNPADDED), columns="witness"),
                  cs.L_UNPADDED, False),
        "witness": (lambda p: p.BitplaneMatcher(from_model(p), columns="witness"), cs.L, False),
    }
    built = {name: (make(old), make(h2r)) for name, (make, _L, _t) in paths.items()}
    with ThreadPoolExecutor(10) as pool:  # every library of both packages at once
        for j in [pool.submit(k.build, m.plan) for pair in built.values()
                  for m, k in zip(pair, (old_k, K))]:
            j.result()
    out = {}
    for B in SIZES:
        for name, (_make, Lc, tiled) in paths.items():
            c_np, l_np = (a[:B] for a in corpora[Lc])
            ln = torch.from_numpy(l_np).to(dev)
            ch = (torch.from_numpy(pk.bp.tile_corpus(c_np, Lc)).to(dev) if tiled
                  else torch.from_numpy(c_np).to(dev))
            mo, mn = built[name]
            a, b = mo(ch, ln), mn(ch, ln)
            torch.cuda.synchronize()
            cs.assert_same(f"{name} old vs new", b, a)
            del a, b
            out[f"{name} B={B}"] = in_turns(
                cs, f"wall {name} B={B}", lambda mo=mo, ch=ch, ln=ln: mo(ch, ln),
                lambda mn=mn, ch=ch, ln=ln: mn(ch, ln), flush, card, device_only=False,
                iters=WALL_ITERS)
    return out


def marker_ab(pk, cs, dev, card, flush) -> dict:
    """marker_match's chunked form (``csrc/probe_marker.cu``) against the
    ``--old`` package's (old, new, new, old; where given) and each of
    ``MARKER_VARIANTS`` (kernel, variant, variant, kernel) at every chunk
    length, on the probes' corpus at B=32768 and 4096 x L=1024; ptxas and
    the SASS of both."""
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.probes import probe_tpu57_lib as lib
    from halo2_regex_tpu_torch.probes.probe_tpu64 import batch

    old = importlib.import_module("h2r_old.probes.probe_tpu57_lib") if pk else None

    dirs = {name: variant_csrc(K, f"marker_{name}", edits)
            for name, edits in MARKER_VARIANTS.items()}
    with ThreadPoolExecutor(len(dirs)) as pool:
        jobs = {name: pool.submit(K._build_library, ("probe_marker.cu",), (K.MARKER_MATCH,),
                                  K.PROBE_HEADERS, None, d) for name, d in dirs.items()}
        libs = {name: j.result() for name, j in jobs.items()}
    keys = [probes_key(K)]
    out: dict = {"ptxas": ptxas_of(K, keys, "marker"), "sass": sass_counts(K, keys, "marker")}
    if pk:
        okeys = [probes_key(pk.old_k)]
        out["ptxas_old"] = ptxas_of(pk.old_k, okeys, "marker")
        out["sass_old"] = sass_counts(pk.old_k, okeys, "marker_chunked")
    for ln in out["ptxas"] + out.get("ptxas_old", []):
        print(ln, flush=True)
    L = 1024
    for B in SIZES:
        chars, lengths = batch(B, L, dev)
        st = lib.marker_stack(chars, lengths)
        want = lib.marker_match_reduced_plain(st)
        NW = B // 32
        t = cs.time_ms(lambda: st.clone(), flush, device_only=True)
        print(f"marker B={B}: the stack's clone {cs.fmt(t)} ({2 * st.numel() * 4 / 1e6:.1f} MB "
              f"moved); card {card}", flush=True)
        out[f"marker B={B} clone_ms"] = t["median"]
        for chunk in (8, 16):
            t = cs.time_ms(lambda c=chunk: lib.marker_match(st, c), ReadFlush(flush), True)
            print(f"marker B={B} chunk {chunk} after a read flush: {cs.fmt(t)}; card {card}",
                  flush=True)
            out[f"marker B={B} chunk {chunk} read_flush_ms"] = t["median"]
        for chunk in lib.CHUNKS:
            check(cs, f"marker chunk {chunk}", lib.marker_match(st, chunk), want)
            if old:
                check(cs, f"marker chunk {chunk} old", old.marker_match(st, chunk), want)
                out[f"marker B={B} chunk {chunk} old/new"] = in_turns(
                    cs, f"marker B={B} chunk {chunk}", lambda c=chunk: old.marker_match(st, c),
                    lambda c=chunk: lib.marker_match(st, c), flush, card)
            for vname, vlib in libs.items():
                got = torch.empty(NW, dtype=torch.int32, device=dev)

                def run_var(vlib=vlib, got=got, chunk=chunk):
                    if vlib.h2r_marker_match(st.data_ptr(), got.data_ptr(), NW, L, chunk,
                                             K._stream(st)):
                        raise RuntimeError("marker variant: launch failed")
                    return got

                if vname not in TIMING_ONLY:
                    check(cs, f"marker {vname}", run_var(), want)
                t = [cs.time_ms(f, flush, device_only=True)
                     for f in (lambda c=chunk: lib.marker_match(st, c), run_var, run_var,
                               lambda c=chunk: lib.marker_match(st, c))]
                name = f"marker B={B} chunk {chunk} {vname}"
                print(f"{name}: kernel {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, variant "
                      f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms (kernel, variant, variant, "
                      f"kernel); card {card}", flush=True)
                out[name] = {"kernel": [t[0]["median"], t[3]["median"]],
                             "variant": [t[1]["median"], t[2]["median"]],
                             "iqr": [x["iqr"] for x in t]}
    return out


def lookup_ab(pk: Pkgs, cs, dev, card, flush) -> dict:
    """dfa_step's lookup (``csrc/probe_dfa_step.cu``, dfa_lookup_kernel)
    at chip_smoke's widths, the from: batch (32768 x 1024, time-major) and
    k7 ([256, 256], batch-major): the ``--old`` package's against the new
    (old, new, new, old) and each of ``LOOKUP_VARIANTS`` against the
    kernel (kernel, variant, variant, kernel); ptxas and the SASS of both."""
    K, old_k = pk.K, pk.old_k
    p1, p2 = (importlib.import_module(f"halo2_regex_tpu_torch.probes.{m}")
              for m in ("probe_tpu", "probe_tpu2"))
    o1 = importlib.import_module("h2r_old.probes.probe_tpu")
    dirs = {name: variant_csrc(K, f"lookup_{name}", edits)
            for name, edits in LOOKUP_VARIANTS.items()}
    with ThreadPoolExecutor(len(dirs)) as pool:
        jobs = {name: pool.submit(K._build_library, ("probe_dfa_step.cu",), (K.DFA_STEP,),
                                  K.PROBE_HEADERS, None, d) for name, d in dirs.items()}
        libs = {name: j.result() for name, j in jobs.items()}
    keys, okeys = [probes_key(K)], [probes_key(old_k)]
    rec = {"ptxas": ptxas_of(K, keys, "dfa_lookup"), "ptxas_old": ptxas_of(old_k, okeys, "dfa_"),
           "sass": sass_counts(K, keys, "dfa_lookup"),
           "sass_old": sass_counts(old_k, okeys, "dfa_kernelILi0")}
    for ln in rec["ptxas"] + rec["ptxas_old"]:
        print(ln, flush=True)
    T = p1.table().to(dev)
    TB, LB = p2.BIG
    widths = [(f"from: batch {TB}x{LB} time-major", p1.bytes_(LB, TB, seed=7, dev=dev), True),
              ("k7 256x256 batch-major", p1.bytes_(256, 256, seed=6, dev=dev), False)]
    for lab, c, tm in widths:
        tb, lb = (c.shape[1], c.shape[0]) if tm else tuple(c.shape)
        want = p1.dfa_step_plain(T, c, "lookup", tm)
        check(cs, f"lookup {lab}", p1.dfa_step(T, c, "lookup", tm), want)
        check(cs, f"lookup {lab} old", o1.dfa_step(T, c, "lookup", tm), want)
        rec[f"lookup {lab} old/new"] = in_turns(
            cs, f"lookup {lab}", lambda c=c, tm=tm: o1.dfa_step(T, c, "lookup", tm),
            lambda c=c, tm=tm: p1.dfa_step(T, c, "lookup", tm), flush, card)
        t = cs.time_ms(lambda c=c, tm=tm: p1.dfa_step(T, c, "lookup", tm), ReadFlush(flush), True)
        print(f"lookup {lab} after a read flush: {cs.fmt(t)}; card {card}", flush=True)
        rec[f"lookup {lab} read_flush_ms"] = t["median"]
        for vname, vlib in libs.items():
            got = torch.empty_like(want)

            def run_var(vlib=vlib, got=got, c=c, tm=tm, tb=tb, lb=lb):
                if vlib.h2r_dfa_step(T.data_ptr(), None, c.data_ptr(), got.data_ptr(), tb, lb,
                                     int(tm), 0, 0, 1, K._stream(c)):
                    raise RuntimeError("lookup variant: launch failed")
                return got

            if vname not in TIMING_ONLY:
                check(cs, f"lookup {vname}", run_var(), want)
            t = [cs.time_ms(f, flush, device_only=True)
                 for f in (lambda c=c, tm=tm: p1.dfa_step(T, c, "lookup", tm), run_var, run_var,
                           lambda c=c, tm=tm: p1.dfa_step(T, c, "lookup", tm))]
            print(f"lookup {lab} variant {vname}: kernel {t[0]['median']:.4f} / "
                  f"{t[3]['median']:.4f} ms, variant {t[1]['median']:.4f} / {t[2]['median']:.4f} "
                  f"ms (kernel, variant, variant, kernel); card {card}", flush=True)
            rec[f"lookup {lab} {vname}"] = {"kernel": [t[0]["median"], t[3]["median"]],
                                            "variant": [t[1]["median"], t[2]["median"]],
                                            "iqr": [x["iqr"] for x in t]}
    return rec


def wide_ab(pk, cs, dev, card, flush) -> dict:
    """dfa_wide at configs[3] and v2's [4096, 128] (hi/lo; v2 with c mod K
    and s mod S): lookup and onehot_mma against the ``--old`` package's
    (old, new, new, old; where given), the lookup against B8's table scan
    at configs[3] (kernel, B8, B8, kernel), onehot_mma against each of
    ``wide_variants`` and the lookup against each of ``LOOKUP_FORMS``
    (kernel, variant, variant, kernel), each new form after a reading
    flush too; ptxas and the SASS of both kernels."""
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.probes import probe_tpu28 as p28

    o28 = importlib.import_module("h2r_old.probes.probe_tpu28") if pk else None
    dirs = {name: variant_csrc(K, f"wide_{name}", edits)
            for name, edits in wide_variants(K).items()}
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        jobs = {name: pool.submit(K._build_library, (_W,), (K.DFA_WIDE,), K.PROBE_HEADERS, None,
                                  d) for name, d in dirs.items()}
        if pk:
            pool.submit(pk.old_k.build_probes).result()
        K.build_probes()
        libs = {name: j.result() for name, j in jobs.items()}
    keys = [probes_key(K)]
    rec: dict = {"ptxas": ptxas_of(K, keys, "wide_"), "sass": sass_counts(K, keys, "wide_")}
    if pk:
        okeys = [probes_key(pk.old_k)]
        rec["ptxas_old"] = ptxas_of(pk.old_k, okeys, "wide_")
    for ln in rec["ptxas"] + rec.get("ptxas_old", []):
        print(ln, flush=True)

    def turns(name, a, b, labels, iters=10):
        t = [cs.time_ms(f, flush, device_only=True, iters=iters) for f in (a, b, b, a)]
        print(f"{name}: {labels[0]} {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, {labels[1]} "
              f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms ({labels[0]}, {labels[1]}, "
              f"{labels[1]}, {labels[0]}); card {card}", flush=True)
        return {labels[0]: [t[0]["median"], t[3]["median"]],
                labels[1]: [t[1]["median"], t[2]["median"]], "iqr": [x["iqr"] for x in t]}

    model, chars3, _l = cs.config3(h2r)
    m3 = h2r.PallasMatcher(model, max_pairs=4096, device=dev)
    nt, cmap = m3.next_table[0], m3.class_map[0]
    ch3 = torch.from_numpy(chars3).to(dev)
    widths = {}
    B_, L_ = ch3.shape
    tbl = p28.as_table(torch.cat([nt & 255, nt >> 8], 1))
    cls = cmap.long()[ch3.long()].t().contiguous().to(torch.int32)
    entry = torch.full((B_,), int(m3.first_states[0]), dtype=torch.int32, device=dev)
    widths["configs3 64x65536"] = (tbl, cls, dict(hilo=True, entry=entry))
    t2, c2 = p28.probe_inputs(4096, 128, dev=dev)
    widths["v2 4096x128"] = (t2, c2, dict(hilo=True, cmod=True, smod=True))
    for lab, (tbl, cls, kw) in widths.items():
        K_, W = tbl.shape
        L2, TB = cls.shape
        want = p28.dfa_wide_plain(tbl, cls, **kw)
        frags = p28.b_fragments(tbl)
        for form in ("lookup", "onehot_mma"):
            new = lambda form=form: p28.dfa_wide(tbl, cls, form=form, frags=frags, **kw)  # noqa: E731
            check(cs, f"{lab} {form}", new(), want)
            iters = 3 if form == "onehot_mma" and lab.startswith("configs3") else 10
            if o28:
                old = lambda form=form: o28.dfa_wide(tbl, cls, form=form, **kw)  # noqa: E731
                check(cs, f"{lab} {form} old", old(), want)
                rec[f"{lab} {form} old/new"] = turns(f"{lab} {form}", old, new, ("old", "new"),
                                                     iters)
            t = cs.time_ms(new, ReadFlush(flush), True)
            print(f"{lab} {form} after a read flush: {cs.fmt(t)}; card {card}", flush=True)
            rec[f"{lab} {form} read_flush_ms"] = t["median"]
        lookup = lambda: p28.dfa_wide(tbl, cls, **kw)  # noqa: E731
        if lab.startswith("configs3"):
            n16 = (nt * 2).to(torch.int16).reshape(1, *nt.shape)
            init = entry.reshape(1, B_)

            def b8():
                out = torch.empty((1, L2, B_), dtype=torch.int32, device=dev)
                K.table_scan_cuda(m3.class_map, m3.next_table, ch3, init, 0, L2, out,
                                  next16=n16)
                return out[0]

            check(cs, "b8", b8(), want)
            rec[f"{lab} lookup/b8"] = turns(f"{lab} lookup against B8", lookup, b8,
                                            ("kernel", "b8"))
            before = p28.lookup_repaired(dev)
            lookup()
            rec[f"{lab} lookup repaired"] = p28.lookup_repaired(dev) - before
            print(f"{lab} lookup {p28.lookup_form(TB, L2, dev)}: "
                  f"{rec[f'{lab} lookup repaired']} positions repaired", flush=True)
        for name, cw in LOOKUP_FORMS.items():
            var = lambda cw=cw: p28.dfa_wide_cuda(tbl, cls, form="lookup", cw=cw, **kw)  # noqa: E731
            check(cs, f"{lab} lookup {name}", var(), want)
            rec[f"{lab} lookup {name}"] = turns(f"{lab} lookup {name}", lookup, var,
                                                ("kernel", "variant"))
        prod = lambda: p28.dfa_wide(tbl, cls, form="onehot_mma", frags=frags, **kw)  # noqa: E731
        for vname, vlib in libs.items():
            got = torch.empty_like(want)
            e = kw.get("entry")
            e = torch.zeros(TB, dtype=torch.int32, device=dev) if e is None else e

            def run_var(vlib=vlib, got=got, e=e):
                if vlib.h2r_dfa_wide(tbl.data_ptr(), frags.data_ptr(), cls.data_ptr(),
                                     e.data_ptr(), got.data_ptr(), None, None, TB, L2, K_, W,
                                     int(kw.get("hilo", False)), int(kw.get("cmod", False)),
                                     int(kw.get("smod", False)), 1, 0, 0, 0, K._stream(cls)):
                    raise RuntimeError("dfa_wide variant: launch failed")
                return got

            if vname not in TIMING_ONLY:
                check(cs, f"{lab} onehot_mma {vname}", run_var(), want)
            rec[f"{lab} onehot_mma {vname}"] = turns(
                f"{lab} onehot_mma {vname}", prod, run_var, ("kernel", "variant"),
                3 if lab.startswith("configs3") else 10)
    return rec


# the chunked scans' variants (csrc/probe_tpu9.cu floor_chunk_kernel,
# csrc/probe_slab.cuh slab_chunk_kernel):
# - c64, c128, c256, c512: every call over tiles of that C (the entries'
#   switch sends every chunk to it; the library compiles only the C that
#   ``kernels.scan_chunk`` picks, 64, 128 and 512);
# - n_sub4, n_sub16: 4 or 16 warps a block, so 4 or 16 sub-chunks a chunk
#   (8 or 2 strings a warp in the maps);
# - two_launches: launch 1 publishes every tile's sums or maps; launch 2
#   walks the tile again and takes its prefix from all earlier tiles' (no
#   look-back, no waiting), then stores;
# - window1: the look-back reads one earlier tile a round (the kernels: 8
#   for loop_floor, 2 for the slab kernel);
# - slab_wide: the maps never go narrow; slab_no_constant: no end state is
#   published before the look-back;
# - timing only: no_compute (loop_floor without its adds, the slab kernel
#   without its maps), no_store, no_lookback (every tile from the start:
#   prefix 0, state ``first``)
_F, _S, _LB = "probe_tpu9.cu", "probe_slab.cuh", "probe_lookback.cuh"
_FLOOR_AGG_PASS = """    if (agg_pass) {
      probe_lookback::st_relaxed(mine, tag | agg);
    } else {
      for (int k = (int)t - n_grp; k >= 0; k -= n_grp)
        excl += (uint32_t)probe_lookback::ld_relaxed(status + (size_t)k * 32 + lane);
    }"""
_SLAB_AGG_PASS = """  if (agg_pass) {
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) {
      unsigned long long word = (unsigned long long)epoch << 40;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        word |= (unsigned long long)__shfl_sync(kFull, s[q], (lane & ~7) + i) << (5 * i);
      if ((lane & 7) == 0)
        probe_lookback::st_relaxed(map_words(status, t, str0 + q) + (lane >> 3), word);
    }
    return;
  }
  int st[kChunkStrings];
#pragma unroll
  for (int q = 0; q < kChunkStrings; ++q) {
    int acc = lane;
    for (int kk = (int)t - n_grp; kk >= 0; kk -= n_grp) {
      const unsigned long long m =
          probe_lookback::ld_relaxed(map_words(status, kk, str0 + q) + (lane >> 3));
      acc = __shfl_sync(kFull, acc, (int)(m >> (5 * (lane & 7))) & 31);
    }
    st[q] = __shfl_sync(kFull, acc, first);
    if (lane == 0) start[str0 + q] = st[q];
  }
  __syncthreads();
"""


def scan_variants(K) -> dict:
    """``SCAN_VARIANTS``: edits of the csrc/ sources as they are (the
    two-launch variant replaces whole blocks of them)."""
    f_src, s_src = (K.CSRC / _F).read_text(), (K.CSRC / _S).read_text()
    floor_lb = _block(f_src, "    if (r == 0) {\n      probe_lookback::st_relaxed(mine, tag | inc | agg);",
                      "      probe_lookback::st_relaxed(mine, tag | inc | (excl + agg));\n    }")
    slab_lb = _block(s_src, "  // 3. start states: publish the maps at once",
                     "      start[str0 + q] = st[q];\n    }\n  }\n  __syncthreads();\n")
    floor_launch = ("  floor_chunk_kernel<R><<<n_blk, kFloorThreads, 0, st>>>(\n"
                    "      (const int32_t*)x, (int32_t*)o, L, TB,")
    slab_launch = ("  slab_chunk_kernel<N_OUT, C><<<n_blk, kChunkThreads, smem, st>>>(\n"
                   "      (const int32_t*)tk, (const int32_t*)classes, (const int32_t*)x, o, L, TB,")
    floor_sig = ("floor_chunk_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, "
                 "int L, int TB,\n")
    slab_sig = ("                  const int32_t* __restrict__ x, Outs<N_OUT> outs, int L, int TB, "
                "int K, int S,\n")
    chunks = {f"c{c}": [(_F, "    switch (chunk) {\n      case 64: return floor_chunk<8>(",
                         f"    switch (chunk = 64) {{\n      case 64: return floor_chunk<{c // 8}>("),
                        (_S, "  switch (chunk) {\n    case 64: return launch_chunked<N_OUT, 64>(",
                         f"  switch (chunk = 64) {{\n    case 64: return launch_chunked<N_OUT, {c}>(")]
              for c in (64, 128, 256, 512)}
    return {
        **chunks,
        "n_sub4": [(_S, "constexpr int kChunkWarps = 8;", "constexpr int kChunkWarps = 4;")],
        "n_sub16": [(_S, "constexpr int kChunkWarps = 8;", "constexpr int kChunkWarps = 16;")],
        "two_launches": [
            (_F, floor_sig, floor_sig.replace("int TB,", "int TB_arg,")),
            (_F, "  constexpr int C = kFloorWarps * R;\n",
             "  constexpr int C = kFloorWarps * R;\n  const bool agg_pass = TB_arg < 0;\n"
             "  const int TB = agg_pass ? -TB_arg : TB_arg;\n"),
            (_F, floor_lb, _FLOOR_AGG_PASS),
            (_F, "  __syncthreads();\n  const uint32_t add = before[lane] + part[w][lane];",
             "  __syncthreads();\n  if (agg_pass) return;\n"
             "  const uint32_t add = before[lane] + part[w][lane];"),
            (_F, floor_launch, floor_launch.replace("L, TB,", "L, -TB,") + " (uint32_t*)scratch,\n"
             "      (unsigned long long*)((char*)scratch + probe_lookback::kTicketBytes), epoch);\n"
             + floor_launch),
            (_S, slab_sig, slab_sig.replace("int TB,", "int TB_arg,")),
            (_S, "  constexpr int kRows = C / kChunkWarps;",
             "  const bool agg_pass = TB_arg < 0;\n  const int TB = agg_pass ? -TB_arg : TB_arg;\n"
             "  constexpr int kRows = C / kChunkWarps;"),
            (_S, slab_lb, _SLAB_AGG_PASS),
            (_S, slab_launch, slab_launch.replace("L, TB,", "L, -TB,") + " K, S, first,\n"
             "      (uint32_t*)scratch, (char*)scratch + probe_lookback::kTicketBytes, epoch);\n"
             + slab_launch)],
        "window1": [(_LB, "constexpr int kWindow = 8;", "constexpr int kWindow = 1;"),
                    (_S, "constexpr int kSlabWindow = 2;", "constexpr int kSlabWindow = 1;")],
        "slab_wide": [(_S, "      if (fits) {", "      if (fits && L < 0) {")],
        "slab_no_constant": [(_S, "    if (r > 0 && __all_sync(kFull, s[q] == __shfl_sync(kFull, s[q], 0))) {",
                              "    if (L < 0 && __all_sync(kFull, s[q] == __shfl_sync(kFull, s[q], 0))) {")],
        "no_compute": [(_F, "  for (int i = 1; i < R; ++i) v[i] += v[i - 1];", "  for (int i = 1; i < 0; ++i) {}"),
                       (_S, "  for (int k = 0; k < kChunkWarps; ++k) {\n    if (k) {",
                        "  for (int k = 0; k < (L < 0); ++k) {\n    if (k) {")],
        "no_store": [(_F, "      if (i0 + i < L) o[(size_t)(i0 + i) * TB + b]",
                      "      if (L < 0) o[(size_t)(i0 + i) * TB + b]"),
                     (_S, "    if (b < TB) {\n      const size_t at", "    if (L < 0) {\n      const size_t at")],
        "no_lookback": [(_F, "    if (r == 0) {\n      probe_lookback::st_relaxed(mine, tag | inc | agg);",
                         "    if (L > 0) {\n      probe_lookback::st_relaxed(mine, tag | inc | agg);"),
                        (_S, "    k[q] = r == 0 ? -1 : (int)t - n_grp;", "    k[q] = -1;")],
    }


# bitop_scan's table form's variants (csrc/probe_tpu20.cu), code that each
# inserts:
# - split: T as a 4-bit table (8 entries a word, 512 words a state row)
#   and a 2-bit table (16 a word, 256 a row) read at the same index, two
#   independent LDS, each unpacked by a shift and a mask (the kernel: five
#   6-bit entries a word, one LDS);
# - per_bit: each lane builds its index from the 12 class words of each
#   step (broadcast LDS, a shift and a mask a bit) in place of the warp
#   transpose;
# - timing only: no_chain (the next state is the index's low bits: every
#   lookup, ballot and store, but no lookup waits for the one before),
#   no_load (no class words copied: the ring's stale words), no_transpose
#   (the raw words as indices), no_ballot (a step's word as its output),
#   chain_only (the last three at once: the chain and its index work alone)
_B = "probe_tpu20.cu"
_PACKED_BUILD = """  for (int w = t; w < kTabRowWords; w += kBuildThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < kTabPerWord; ++i) {
      const int cls = kTabPerWord * w + i;
      if (cls < kTabClasses) word |= (uint32_t)ent[cls] << (6 * i);
    }
    tab[(size_t)st * kTabRowWords + w] = word;
  }"""
_SPLIT_BUILD = """  for (int w = t; w < kTabClasses / 8; w += kBuildThreads) {
    uint32_t lo = 0;
    for (int i = 0; i < 8; ++i) lo |= (uint32_t)(ent[8 * w + i] & 15) << (4 * i);
    tab[(size_t)st * (kTabClasses / 8) + w] = lo;
  }
  for (int w = t; w < kTabClasses / 16; w += kBuildThreads) {
    uint32_t hi = 0;
    for (int i = 0; i < 16; ++i) hi |= (uint32_t)(ent[16 * w + i] >> 4) << (2 * i);
    tab[kTabStates * (kTabClasses / 8) + (size_t)st * (kTabClasses / 16) + w] = hi;
  }"""
_PACKED_AT = """    const uint32_t prod = idx * 52429u;
    const uint32_t at = tab + ((prod >> 16) & ~3u);  // 4 (idx / 5)
    const uint32_t sh = (prod >> 13) & 30u;          // 6 (idx % 5)"""
_SPLIT_AT = """    const uint32_t at = tab + 4u * (idx >> 3), sh = (idx & 7) * 4;
    const uint32_t at2 = tab + 4u * (kTabStates * (kTabClasses / 8) + (idx >> 4));
    const uint32_t sh2 = (idx & 15) * 2;"""
_PACKED_LDS = """    uint32_t a, w;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(a) : "r"(st), "n"(4 * kTabRowWords), "r"(at));
    asm("ld.shared.u32 %0, [%1];" : "=r"(w) : "r"(a));
    words[j] = __ballot_sync(0xFFFFFFFFu, w & (32u << sh));
    st = (w >> sh) & 63u;"""
_SPLIT_LDS = """    uint32_t w, w2;
    asm("ld.shared.u32 %0, [%1];" : "=r"(w) : "r"(at + st * (4u * (kTabClasses / 8))));
    asm("ld.shared.u32 %0, [%1];" : "=r"(w2) : "r"(at2 + st * (4u * (kTabClasses / 16))));
    words[j] = __ballot_sync(0xFFFFFFFFu, w2 & (2u << sh2));
    st = ((w >> sh) & 15u) | (((w2 >> sh2) & 3u) << 4);"""
_TRANSPOSE = "  for (int k = 0; k < kTsX; ++k) xn[k] = transpose32(col[32 * k + lane], keep, rot);"
_PER_BIT = """  for (int k = 0; k < kTsX; ++k) {
    uint32_t x = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) x |= ((col[32 * k + r] >> lane) & 1u) << r;
    xn[k] = x;
  }"""
_COPY4 = """          probe_ring::copy4(dst + 4u * kRowsAPass * i, src + (size_t)kRowsAPass * i * NW);"""
BITOP_VARIANTS = {
    "split": [(_B, _PACKED_BUILD, _SPLIT_BUILD), (_B, _PACKED_AT, _SPLIT_AT),
              (_B, _PACKED_LDS, _SPLIT_LDS)],
    "per_bit": [(_B, _TRANSPOSE, _PER_BIT)],
    "no_chain": [(_B, "    st = (w >> sh) & 63u;", "    st = idx & 63u;")],
    "no_load": [(_B, _COPY4, "          (void)src;")],
    "no_transpose": [(_B, _TRANSPOSE, "  for (int k = 0; k < kTsX; ++k) xn[k] = col[32 * k + lane];")],
    "no_ballot": [(_B, "    words[j] = __ballot_sync(0xFFFFFFFFu, w & (32u << sh));",
                   "    words[j] = w;")],
    "chain_only": [(_B, _TRANSPOSE, "  for (int k = 0; k < kTsX; ++k) xn[k] = col[32 * k + lane];"),
                   (_B, "    words[j] = __ballot_sync(0xFFFFFFFFu, w & (32u << sh));",
                    "    words[j] = w;"),
                   (_B, _COPY4, "          (void)src;")],
}


def scan_ab(pk, cs, dev, card, flush) -> dict:
    """The chunked loop_floor and slab kernels (``csrc/probe_tpu9.cu``,
    ``csrc/probe_slab.cuh``) at chip_smoke's [10] and [11] widths and
    probe_tpu6's k1 and k3: the ``--old`` package's (its serial kernels;
    where given) against the new, in turns (old, new, new, old) after the
    write flush and after a reading flush (``ReadFlush``); the new
    kernels against ``scan_variants`` (kernel, variant, variant, kernel;
    at k3 only the other C); the serial forms; B8's speculation
    and repair (``table_scan_cuda`` chunked, W = C) in place of the maps on
    the probe's table and on a permutation table, against slab_anatomy's
    one output; ptxas and the SASS of both kernels."""
    import numpy as np

    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.probes import probe_tpu6 as p6
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    o9 = importlib.import_module("h2r_old.probes.probe_tpu9") if pk else None
    o18 = importlib.import_module("h2r_old.probes.probe_tpu18") if pk else None
    srcs = ("probe_tpu9.cu", "probe_tpu18.cu")
    dirs = {name: variant_csrc(K, f"scan_{name}", edits)
            for name, edits in scan_variants(K).items()}
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        jobs = {name: pool.submit(K._build_library, srcs, (K.LOOP_FLOOR, K.SLAB_SCAN,
                                                           K.SLAB_ANATOMY), K.PROBE_HEADERS,
                                  None, d) for name, d in dirs.items()}
        if pk:
            pool.submit(pk.old_k.build_probes).result()
        K.build_probes()
        libs = {name: j.result() for name, j in jobs.items()}
    keys = [probes_key(K)]
    rec: dict = {"ptxas": ptxas_of(K, keys, "_chunk_kernel"),
                 "sass": sass_counts(K, keys, "_chunk_kernel")}
    for ln in rec["ptxas"]:
        print(ln, flush=True)

    def turns(name, a, b, labels, fl=flush):
        t = [cs.time_ms(f, fl, device_only=True) for f in (a, b, b, a)]
        print(f"{name}: {labels[0]} {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, {labels[1]} "
              f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms ({labels[0]}, {labels[1]}, "
              f"{labels[1]}, {labels[0]}); card {card}", flush=True)
        return {labels[0]: [t[0]["median"], t[3]["median"]],
                labels[1]: [t[1]["median"], t[2]["median"]], "iqr": [x["iqr"] for x in t]}

    def tiles(x):  # the grid at the smallest C: the scratch of every variant
        return -(-x.shape[1] // 32) * -(-x.shape[0] // min(K.SCAN_CHUNKS))

    def floor_var(lib, x, slab, c):
        out = torch.empty_like(x)
        L_, TB_ = x.shape
        sc, ep = K.lookback_scratch(K.LOOP_FLOOR, x, tiles(x))
        if lib.h2r_loop_floor(x.data_ptr(), out.data_ptr(), slab, L_, TB_, c, sc, ep,
                              K._stream(x)):
            raise RuntimeError("loop_floor variant: launch failed")
        return out

    def slab_var(lib, tab, cls, x, first, n_out, c):
        L_, TB_ = x.shape
        outs = [torch.empty_like(x) for _ in range(n_out)]
        sc, ep = K.lookback_scratch(K.SLAB_ANATOMY, x, tiles(x))
        ptrs = [o.data_ptr() for o in outs] + [None] * (4 - n_out)
        if lib.h2r_slab_anatomy(tab.data_ptr(), cls.data_ptr(), x.data_ptr(), *ptrs, L_, TB_,
                                tab.shape[0], tab.shape[1] // 4, first, n_out, c, sc, ep,
                                K._stream(x)):
            raise RuntimeError("slab variant: launch failed")
        return tuple(outs)

    def variants(lab, new, run_var, want, c, only_c=False):
        for vname, vlib in libs.items():
            if vname == f"c{c}" or (only_c and not vname.startswith("c")):
                continue
            f = lambda vlib=vlib: run_var(vlib)  # noqa: E731
            if vname not in TIMING_ONLY:
                check(cs, f"{lab} {vname}", f(), want)
            rec[f"{lab} {vname}"] = turns(f"{lab} {vname} (kernel: C = {c})", new, f,
                                          ("kernel", "variant"))

    # loop_floor at [10]'s widths, k1's
    for L_, TB_ in cs.FLOOR_WIDTHS + ((128, 256),):
        x = p9.inputs(L_, TB_, dev=dev)[0] if TB_ != 256 or L_ != 128 else \
            p6.inputs(dev=dev)["x1"]
        lab = f"loop_floor {L_}x{TB_}"
        want = p9.loop_floor_plain(x)
        c0 = K.scan_chunk(L_, TB_, dev)
        for slab in (1, 8):
            new = lambda slab=slab: p9.loop_floor(x, slab)  # noqa: E731
            check(cs, f"{lab} slab {slab}", new(), want)
            if o9:
                old = lambda slab=slab: o9.loop_floor(x, slab)  # noqa: E731
                check(cs, f"{lab} slab {slab} old", old(), want)
                rec[f"{lab} slab {slab} old/new"] = turns(f"{lab} slab {slab}", old, new,
                                                          ("old", "new"))
                rec[f"{lab} slab {slab} old/new read_flush"] = turns(
                    f"{lab} slab {slab} after a read flush", old, new, ("old", "new"),
                    ReadFlush(flush))
            ser = lambda slab=slab: p9.loop_floor(x, slab, "serial")  # noqa: E731
            check(cs, f"{lab} slab {slab} serial", ser(), want)
            rec[f"{lab} slab {slab} serial"] = turns(f"{lab} slab {slab} serial", new, ser,
                                                     ("kernel", "serial"))
        new = lambda: p9.loop_floor(x, 1)  # noqa: E731
        lib_t = cs.time_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), flush, True)
        print(f"{lab} torch.cumsum: {cs.fmt(lib_t)}; card {card}", flush=True)
        rec[f"{lab} cumsum_ms"] = lib_t["median"]
        variants(lab, new, lambda vlib: floor_var(vlib, x, 1, c0), want, c0)

    # the slab kernel: slab_scan at [10]'s widths, slab_anatomy at [11]'s and k3's
    model = h2r.zoo.email_headers_model(max_chars_size=p18.L, headers=("from",))
    tab18, cls18, first18 = (v.to(dev) if isinstance(v, torch.Tensor) else v
                             for v in p18.slab_tables(model))
    t6 = p6.inputs(dev=dev)
    ident = torch.arange(256, dtype=torch.int32, device=dev)
    cases = []
    for L_, TB_ in cs.SLAB_WIDTHS:
        x, cls9, tk9 = p9.inputs(L_, TB_, dev=dev)
        cases.append((f"slab_scan {L_}x{TB_}", tk9, cls9, x, 0, 4, "scan"))
    x18 = p18.inputs(p18.L, p18.B, dev=dev)
    cases += [(f"slab_anatomy n_out {n} {p18.L}x{p18.B}", tab18, cls18, x18, first18, n,
               "anatomy") for n in (1, 2, 4)]
    cases.append(("k3 128x128", t6["P4"], ident, t6["x3"], 0, 2, "anatomy"))
    for lab, tab, cls, x, first, n_out, kind in cases:
        L_, TB_ = x.shape
        want = p9.slab_plain(tab, cls, x, first, n_out)
        c0 = K.scan_chunk(L_, TB_, dev)
        if kind == "scan":
            new = lambda tab=tab, cls=cls, x=x: p9.slab_scan(tab, cls, x)  # noqa: E731
            ser = lambda tab=tab, cls=cls, x=x: p9.slab_scan(tab, cls, x, "serial")  # noqa: E731
            old = (lambda tab=tab, cls=cls, x=x: o9.slab_scan(tab, cls, x)) if o9 else None
        else:
            new = lambda tab=tab, cls=cls, x=x, f=first, n=n_out: \
                p18.slab_anatomy(tab, cls, x, f, n)  # noqa: E731
            ser = lambda tab=tab, cls=cls, x=x, f=first, n=n_out: \
                p18.slab_anatomy(tab, cls, x, f, n, "serial")  # noqa: E731
            old = (lambda tab=tab, cls=cls, x=x, f=first, n=n_out:
                   o18.slab_anatomy(tab, cls, x, f, n)) if o18 else None
        check(cs, lab, new(), want)
        check(cs, f"{lab} serial", ser(), want)
        if old:
            check(cs, f"{lab} old", old(), want)
            rec[f"{lab} old/new"] = turns(lab, old, new, ("old", "new"))
            rec[f"{lab} old/new read_flush"] = turns(f"{lab} after a read flush", old, new,
                                                     ("old", "new"), ReadFlush(flush))
        rec[f"{lab} serial"] = turns(f"{lab} serial", new, ser, ("kernel", "serial"))
        variants(lab, new, lambda vlib, tab=tab, cls=cls, x=x, fi=first, n=n_out, c0=c0:
                 slab_var(vlib, tab, cls, x, fi, n, c0), want, c0, lab.startswith("k3"))

    # B8's speculation and repair (W = C) in place of the maps: its states
    # are slab_anatomy's one output, on the probe's table and on a
    # permutation table (no two walks ever meet: every chunk repaired)
    L3, B3 = cs.L3, cs.B3
    x, cls9, tk9 = p9.inputs(L3, B3, dev=dev)
    rng = np.random.default_rng(9)
    perm = torch.from_numpy(np.stack([np.concatenate([rng.permutation(p9.S) for _ in range(4)])
                                      for _ in range(p9.K)]).astype(np.int32)).to(dev)
    chars = x.clamp(0, 255).to(torch.uint8).t().contiguous()
    for tname, tab in (("probe table", tk9), ("permutation table", perm)):
        lab = f"maps against B8 {L3}x{B3} {tname}"
        want = p9.slab_plain(tab, cls9, x, 0, 1)
        c0 = K.scan_chunk(L3, B3, dev)
        new = lambda tab=tab: p18.slab_anatomy(tab, cls9, x, 0, 1)  # noqa: E731
        check(cs, lab, new(), want)
        next_tab = tab[:, :p9.S].reshape(1, p9.K, p9.S).contiguous()
        init = torch.zeros((1, B3), dtype=torch.int32, device=dev)

        def b8(next_tab=next_tab, c=c0):
            out = torch.empty((1, L3, B3), dtype=torch.int32, device=dev)
            K.table_scan_cuda(cls9.reshape(1, 256), next_tab, chars, init, 0, L3, out,
                              form=(c, c))
            return (out[0],)

        check(cs, f"{lab} b8", b8(), want)
        before = K.table_scan_repaired(dev)
        b8()
        rec[f"{lab} b8 repaired"] = K.table_scan_repaired(dev) - before
        print(f"{lab}: B8 (C = W = {c0}) repaired {rec[f'{lab} b8 repaired']} positions",
              flush=True)
        rec[lab] = turns(lab, new, b8, ("kernel", "b8"))
        ser = lambda tab=tab: p18.slab_anatomy(tab, cls9, x, 0, 1, "serial")  # noqa: E731
        rec[f"{lab} serial"] = turns(f"{lab} serial", new, ser, ("kernel", "serial"))
    return rec


def bitop_ab(pk, cs, dev, card, flush) -> dict:
    """bitop_scan's table form (P4) at [1024, 12, 8, 128]: against the
    ``--old`` package's serial kernel (where given) at each n_ops, old,
    new, new, old, after the write flush and after a reading flush;
    against its own serial form; against ``BITOP_VARIANTS`` at n_ops 96
    and 768 (kernel, variant, variant, kernel; each variant's T built by
    its own library); the table's build time at each n_ops.  chains' fixed
    form (P5) against its serial form and the ``--old`` package's at each
    C and geometry, with the steps its calls ran.  ptxas and the SASS of
    the new kernels."""
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20
    from halo2_regex_tpu_torch.probes import probe_tpu56 as p56

    o20 = importlib.import_module("h2r_old.probes.probe_tpu20") if pk else None
    o56 = importlib.import_module("h2r_old.probes.probe_tpu56") if pk else None
    dirs = {name: variant_csrc(K, f"bitop_{name}", edits)
            for name, edits in BITOP_VARIANTS.items()}
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        jobs = {name: pool.submit(K._build_library, (_B,), (K.BITOP_SCAN, K.BITOP_TABLE),
                                  K.PROBE_HEADERS, None, d) for name, d in dirs.items()}
        if pk:
            pool.submit(pk.old_k.build_probes).result()
        K.build_probes()
        libs = {name: j.result() for name, j in jobs.items()}
    keys = [probes_key(K)]
    rec: dict = {"ptxas": ptxas_of(K, keys, "bitop_table") + ptxas_of(K, keys, "chains"),
                 "sass": sass_counts(K, keys, "bitop_table") + sass_counts(K, keys, "chains")}
    for ln in rec["ptxas"]:
        print(ln, flush=True)

    def turns(name, a, b, labels, fl=flush):
        t = [cs.time_ms(f, fl, device_only=True) for f in (a, b, b, a)]
        print(f"{name}: {labels[0]} {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, {labels[1]} "
              f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms ({labels[0]}, {labels[1]}, "
              f"{labels[1]}, {labels[0]}); card {card}", flush=True)
        return {labels[0]: [t[0]["median"], t[3]["median"]],
                labels[1]: [t[1]["median"], t[2]["median"]], "iqr": [x["iqr"] for x in t]}

    cls, st0 = p20.inputs(p20.L, p20.NWS, dev=dev)
    nw = p20.NWS * p20.LANE
    for n in p20.N_OPS:
        lab = f"bitop_scan n_ops {n}"
        want = p20.bitop_scan_plain(cls, st0, n)
        tw = p20.table_words(p20.bitop_table_plain(n)).to(dev)
        check(cs, f"{lab} table", p20.bitop_table_cuda(n, dev), tw)
        t = cs.time_ms(lambda n=n: p20.bitop_table_cuda(n, dev), flush, True)
        print(f"{lab}: the table's build {cs.fmt(t)}; card {card}", flush=True)
        rec[f"{lab} build_ms"] = t["median"]
        new = lambda n=n: p20.bitop_scan(cls, st0, n)  # noqa: E731
        ser = lambda n=n: p20.bitop_scan(cls, st0, n, form="serial")  # noqa: E731
        check(cs, lab, new(), want)
        check(cs, f"{lab} serial", ser(), want)
        if o20:
            old = lambda n=n: o20.bitop_scan(cls, st0, n)  # noqa: E731
            check(cs, f"{lab} old", old(), want)
            rec[f"{lab} old/new"] = turns(lab, old, new, ("old", "new"))
            rec[f"{lab} old/new read_flush"] = turns(f"{lab} after a read flush", old, new,
                                                     ("old", "new"), ReadFlush(flush))
        rec[f"{lab} serial"] = turns(f"{lab} serial", new, ser, ("kernel", "serial"))
        if n not in (96, 768):
            continue
        for vname, vlib in libs.items():
            vtab = torch.empty(p20.TABLE_WORDS, dtype=torch.int32, device=dev)
            if vlib.h2r_bitop_table(vtab.data_ptr(), n, K._stream(vtab)):
                raise RuntimeError(f"bitop {vname}: the table's build failed")

            def run_var(vlib=vlib, vtab=vtab, n=n):
                out = torch.empty((p20.L, 1, p20.NWS, p20.LANE), dtype=torch.int32, device=dev)
                if vlib.h2r_bitop_scan(cls.data_ptr(), st0.data_ptr(), vtab.data_ptr(),
                                       out.data_ptr(), n, nw, p20.L, p20.LC, K._stream(cls)):
                    raise RuntimeError(f"bitop {vname}: launch failed")
                return out

            if vname not in TIMING_ONLY:
                check(cs, f"{lab} {vname}", run_var(), want)
            rec[f"{lab} {vname}"] = turns(f"{lab} variant {vname}", new, run_var,
                                          ("kernel", "variant"))

    for c in p56.CHAINS:
        x = p56.inputs(c, dev=dev)
        want = p56.chains_plain(x)
        for th in p56.THREADS:
            lab = f"chains C {c}, {th} threads a block"
            new = lambda th=th: p56.chains(x, p56.N_STEPS, th)  # noqa: E731
            ser = lambda th=th: p56.chains(x, p56.N_STEPS, th, "serial")  # noqa: E731
            check(cs, lab, new(), want)
            rec[f"{lab} steps"] = p56.chains_steps(dev)
            check(cs, f"{lab} serial", ser(), want)
            rec[f"{lab} serial"] = turns(f"{lab} (fixed form, {rec[f'{lab} steps']} steps)",
                                         new, ser, ("kernel", "serial"))
            if o56:
                old = lambda th=th: o56.chains(x, o56.N_STEPS, th)  # noqa: E731
                check(cs, f"{lab} old", old(), want)
                rec[f"{lab} old/new"] = turns(lab, old, new, ("old", "new"))
    return rec


# bitop_carry's reduce form (P16) and its variants, one a design choice:
# 4-byte loads only (the 16-byte path never taken); the loads by __ldg;
# the other combine, the partial ORs through global memory, the last block
# of each tile (a ticket that wraps, taken by atomicInc) folding them,
# launched without a cluster; and, timed only, no cluster barriers or
# exchange, no loads.  Half the blocks (and the other cluster sizes) are
# calls of the kernel itself at that cluster (``carry_ab``)
_LB_GLOBALS = """constexpr int kLbPairs = 256;  // (b, tile) pairs the variant's scratch holds
__device__ uint4 g_red_parts[kLbPairs * kRedMaxCluster * 32];
__device__ unsigned g_red_ticket[kLbPairs];

template <int V>
__global__ void __launch_bounds__(kRedThreads)
bitop_carry_reduce_kernel("""
_LB_COMBINE = """  const int pair = blockIdx.y * (gridDim.x / cluster) + blockIdx.x / cluster;
  T* gp = reinterpret_cast<T*>(g_red_parts) + (size_t)pair * kRedMaxCluster * 32;
  __shared__ bool last;
  if (warp == 0) {
    gp[rank * 32 + lane] = sum;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicInc(&g_red_ticket[pair], cluster - 1) == (unsigned)(cluster - 1);
  __syncthreads();
  if (last && warp == 0 && col) {
    __threadfence();
    T all = R::zero();
#pragma unroll
    for (int r = 0; r < kRedMaxCluster; ++r)
      if (r < cluster) all = R::or_(all, __ldcg(gp + r * 32 + lane));
    const T s = __ldg(reinterpret_cast<const T*>(st0 + w0));
    *reinterpret_cast<T*>(out + (size_t)b * NW + w0) = R::andnot(s, all);
  }
}"""


_LD4 = """  static __device__ __forceinline__ T load(const T* p) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }"""
_LD1 = """  static __device__ __forceinline__ T load(const T* p) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
  }"""


def carry_variants(K) -> dict:
    """The reduce form's source variants; ``no_sync`` and ``lastblock``
    replace the combine as the source has it."""
    src = (K.CSRC / _B).read_text()
    combine = _block(src, '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");  '
                          '// every rank has started\n  cg::cluster_group cl',
                     "    *reinterpret_cast<T*>(out + (size_t)b * NW + w0) = R::andnot(s, all);"
                     "\n  }\n}")
    return {
        "vec1": [(_B, "    if (NW % 4 == 0 && ((uintptr_t)cls | (uintptr_t)st0 | (uintptr_t)out) "
                      "% 16 == 0)", "    if (false)")],
        # timing only: no cluster barriers or exchange (each rank writes
        # its own partial), and no loads (the launch and the combine alone)
        "no_sync": [
            (_B, '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n'
                 "  const int w0 = ((blockIdx.x", "  const int w0 = ((blockIdx.x"),
            (_B, combine, "  if (warp == 0 && col)\n    *reinterpret_cast<T*>(out + (size_t)b * NW "
                          "+ w0) = R::andnot(s, sum);\n}")],
        "no_load": [(_B, "      if (col && p + k < hi) v[k] = R::load(base + (size_t)(j * LC + i) * "
                         "row_t);", "")],
        # the loads by __ldg (L1 bypass and the 256-byte L2 runs not asked)
        "ldg": [(_B, _LD4, "  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }"),
                (_B, _LD1, "  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }")],
        "lastblock": [
            (_B, "template <int V>\n__global__ void __launch_bounds__(kRedThreads)\n"
                 "bitop_carry_reduce_kernel(", _LB_GLOBALS),
            (_B, '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n'
                 "  const int w0 = ((blockIdx.x", "  const int w0 = ((blockIdx.x"),
            (_B, combine, _LB_COMBINE),
            (_B, "  cfg.numAttrs = cluster > 1;", "  cfg.numAttrs = 0;")]}


# lane_gather's pow form (P6): eight rows (warps) a block in place of one
GATHER_VARIANTS = {
    "rows8": [("probe_gather.cu", "constexpr int kPowRows = 1;", "constexpr int kPowRows = 8;")],
}


def _turns(cs, card, flush, name, a, b, labels, fl=None) -> dict:
    """a, b, b, a (device time, the L2 flushed by ``fl``, else ``flush``)."""
    t = [cs.time_ms(f, fl or flush, device_only=True) for f in (a, b, b, a)]
    print(f"{name}: {labels[0]} {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, {labels[1]} "
          f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms ({labels[0]}, {labels[1]}, "
          f"{labels[1]}, {labels[0]}); card {card}", flush=True)
    return {labels[0]: [t[0]["median"], t[3]["median"]],
            labels[1]: [t[1]["median"], t[2]["median"]], "iqr": [x["iqr"] for x in t]}


def carry_ab(pk, cs, dev, card, flush) -> dict:
    """bitop_carry's reduce form (P16) at E's [2, 1024, 1, 8, 128] (one
    read a chunk from a zero and a seeded start, every position) and every
    position at [2, 8192, 1, 8, 128] (64 MiB): against the ``--old``
    package's (its serial kernel; old, new, new, old, after the write
    flush and after a reading flush), against its own serial form, against
    an int64 sum of every word (a read rate, after a reading flush), against
    the variants (``carry_variants``, those not timing-only checked;
    ``half``: the kernel at half its cluster, ``clusterC`` at C blocks a
    cluster), ``ldg`` and ``lastblock`` also after a reading flush; its
    geometry and bytes bound beside it; ptxas and the SASS of the reduce
    kernel."""
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    o20 = importlib.import_module("h2r_old.probes.probe_tpu20") if pk else None
    dirs = {name: variant_csrc(K, f"carry_{name}", edits)
            for name, edits in carry_variants(K).items()}
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        jobs = {name: pool.submit(K._build_library, (_B,), (K.BITOP_CARRY,), K.PROBE_HEADERS,
                                  None, d) for name, d in dirs.items()}
        if pk:
            pool.submit(pk.old_k.build_probes).result()
        lib = K.build_probes()
        libs = {name: j.result() for name, j in jobs.items()}
    keys = [probes_key(K)]
    rec: dict = {"ptxas": ptxas_of(K, keys, "bitop_carry_reduce"),
                 "sass": sass_counts(K, keys, "bitop_carry_reduce")}
    for ln in rec["ptxas"]:
        print(ln, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(vlib, cls, s0, lc, steps, cluster, name):
        NB, L_, _one, nws, _lane = cls.shape
        out = torch.empty((NB, 1, 1, nws, p20.LANE), dtype=torch.int32, device=dev)
        if vlib.h2r_bitop_carry(cls.data_ptr(), s0.data_ptr(), out.data_ptr(), NB,
                                nws * p20.LANE, L_, lc, steps, cluster, K._stream(cls)):
            raise RuntimeError(f"bitop_carry {name}: launch failed")
        return out

    cases = []
    for L_ in (p20.L, 8 * p20.L):
        cls, st0 = p20.carry_inputs(L_, p20.NWS, dev=dev)
        if L_ == p20.L:
            cases += [(cls, torch.zeros_like(st0), 1, "zero"), (cls, st0, 1, "seeded")]
        cases.append((cls, st0, p20.LC, "seeded"))
    for cls, s0, steps, start in cases:
        NB, L_ = cls.shape[:2]
        lab = f"bitop_carry {list(cls.shape)} {start} reads {steps}"
        geo = p20.carry_geometry(NB, p20.NWS * p20.LANE, L_, p20.LC, steps,
                                 p20.carry_vec(cls, s0), sms)
        n_pos = geo["n_pos"]
        bd = cs.bound((NB * n_pos * p20.NWS * p20.LANE + s0.numel() + NB * p20.NWS * p20.LANE) * 4,
                      NB * n_pos * p20.NWS * p20.LANE)
        print(f"{lab}: geometry {geo}; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}",
              flush=True)
        rec[f"{lab} geometry"] = geo
        rec[f"{lab} bound"] = bd
        want = p20.bitop_carry_plain(cls, s0, p20.LC, steps)
        new = lambda cls=cls, s0=s0, steps=steps: p20.bitop_carry(cls, s0, p20.LC, steps)  # noqa: E731
        ser = lambda cls=cls, s0=s0, steps=steps: p20.bitop_carry(  # noqa: E731
            cls, s0, p20.LC, steps, "serial")
        check(cs, lab, new(), want)
        check(cs, f"{lab} serial", ser(), want)
        kernels_before = K.BITOP_CARRY.launches
        new()
        rec[f"{lab} launches a call"] = K.BITOP_CARRY.launches - kernels_before
        if o20:
            old = lambda cls=cls, s0=s0, steps=steps: o20.bitop_carry(  # noqa: E731
                cls, s0, p20.LC, steps)
            check(cs, f"{lab} old", old(), want)
            rec[f"{lab} old/new"] = _turns(cs, card, flush, lab, old, new, ("old", "new"))
            rec[f"{lab} old/new read_flush"] = _turns(cs, card, flush,
                                                      f"{lab} after a read flush", old, new,
                                                      ("old", "new"), ReadFlush(flush))
        rec[f"{lab} serial"] = _turns(cs, card, flush, f"{lab} serial", new, ser,
                                      ("kernel", "serial"))
        if steps == p20.LC:  # a read rate to set it by: an int64 sum of every word (not E's function)
            rec[f"{lab} int64_sum read_flush"] = _turns(
                cs, card, flush, f"{lab} beside an int64 sum of cls, after a read flush", new,
                lambda cls=cls: cls.view(torch.int64).sum(), ("kernel", "sum"), ReadFlush(flush))
        runs = {name: (vlib, geo["cluster"]) for name, vlib in libs.items()}
        # half the blocks, and the other cluster sizes the shape takes
        if geo["cluster"] > 1:
            runs["half"] = (lib, geo["cluster"] // 2)
        for c in (1, 2, 4, 8, 16):
            if c not in (geo["cluster"], geo["cluster"] // 2) and c <= n_pos:
                runs[f"cluster{c}"] = (lib, c)
        for vname, (vlib, cl) in runs.items():
            f = lambda vlib=vlib, cl=cl, cls=cls, s0=s0, steps=steps, v=vname: launch(  # noqa: E731
                vlib, cls, s0, p20.LC, steps, cl, v)
            if vname not in TIMING_ONLY:
                check(cs, f"{lab} {vname}", f(), want)
            rec[f"{lab} {vname}"] = _turns(cs, card, flush, f"{lab} variant {vname}", new, f,
                                           ("kernel", "variant"))
            if vname in ("lastblock", "ldg"):
                rec[f"{lab} {vname} read_flush"] = _turns(
                    cs, card, flush, f"{lab} variant {vname} after a read flush", new, f,
                    ("kernel", "variant"), ReadFlush(flush))
    return rec


def gather_ab(pk, cs, dev, card, flush) -> dict:
    """lane_gather's pow form (P6) at 1024 steps on [256, 128] and [1, 128]
    (probe_tpu2's E) and on probe_tpu3's loop, in both stores: against the
    ``--old`` package's (its serial chain; old, new, new, old, after the
    write flush and after a reading flush), against its own serial
    form and against ``GATHER_VARIANTS``, each checked; ptxas and the SASS
    of the pow kernel."""
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.probes import probe_tpu as p1
    from halo2_regex_tpu_torch.probes import probe_tpu2 as p2

    o1 = importlib.import_module("h2r_old.probes.probe_tpu") if pk else None
    dirs = {name: variant_csrc(K, f"gather_{name}", edits)
            for name, edits in GATHER_VARIANTS.items()}
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        jobs = {name: pool.submit(K._build_library, ("probe_gather.cu",), (K.LANE_GATHER,),
                                  K.PROBE_HEADERS, None, d) for name, d in dirs.items()}
        if pk:
            pool.submit(pk.old_k.build_probes).result()
        K.build_probes()
        libs = {name: j.result() for name, j in jobs.items()}
    keys = [probes_key(K)]
    rec: dict = {"ptxas": ptxas_of(K, keys, "gather_pow"),
                 "sass": sass_counts(K, keys, "gather_pow")}
    for ln in rec["ptxas"]:
        print(ln, flush=True)
    steps = p2.E_STEPS
    cases = [(f"E {R}x128", *p1.gather_inputs(R, seed=R + 3, dev=dev)) for R in (256, 1)]
    cases.append(("loop 256x128", *p1.gather_inputs(256, seed=9, dev=dev)))
    for name, g, f in cases:
        for store in p1.STORES:
            lab = f"lane_gather {name} {steps} steps {store}"
            want = p1.lane_gather_plain(g, f, steps, store)
            new = lambda g=g, f=f, store=store: p1.lane_gather(g, f, steps, store)  # noqa: E731
            ser = lambda g=g, f=f, store=store: p1.lane_gather(  # noqa: E731
                g, f, steps, store, "serial")
            check(cs, lab, new(), want)
            check(cs, f"{lab} serial", ser(), want)
            if o1:
                old = lambda g=g, f=f, store=store: o1.lane_gather(g, f, steps, store)  # noqa: E731
                check(cs, f"{lab} old", old(), want)
                rec[f"{lab} old/new"] = _turns(cs, card, flush, lab, old, new, ("old", "new"))
                rec[f"{lab} old/new read_flush"] = _turns(
                    cs, card, flush, f"{lab} after a read flush", old, new, ("old", "new"),
                    ReadFlush(flush))
            rec[f"{lab} serial"] = _turns(cs, card, flush, f"{lab} serial", new, ser,
                                          ("kernel", "serial"))
            for vname, vlib in libs.items():
                def run_var(vlib=vlib, g=g, f=f, store=store):
                    out = torch.empty_like(g)
                    if vlib.h2r_lane_gather(g.data_ptr(), f.data_ptr(), out.data_ptr(),
                                            g.shape[0], steps, p1.STORES.index(store) + 3,
                                            K._stream(g)):
                        raise RuntimeError(f"lane_gather {vname}: launch failed")
                    return out

                check(cs, f"{lab} {vname}", run_var(), want)
                rec[f"{lab} {vname}"] = _turns(cs, card, flush, f"{lab} variant {vname}", new,
                                               run_var, ("kernel", "variant"))
    return rec


def units_ab(pk: Pkgs, cs, dev, card, flush) -> dict:
    """onehot_count (P10) at [1024, 512], mma_accum (P15) at [4, 2, 128,
    128] and [4, 8, 1024, 1024] (integer inputs), int8_mma (P11) at 128^3
    and 4096^3 and dfa_step's product forms (P7) on the from: batch: the
    ``--old`` package's forms against the new ones (old, new, new, old),
    the library call against the kernel (kernel, library, library, kernel)
    and each of ``COUNT_VARIANTS`` / ``MMA_VARIANTS`` / ``INT8_VARIANTS`` /
    ``DFA_VARIANTS`` against the kernel (kernel, variant, variant, kernel);
    ptxas and the SASS of the kernels, old and new."""
    K, old_k = pk.K, pk.old_k
    p1, p2, p17, p21 = (importlib.import_module(f"halo2_regex_tpu_torch.probes.{m}")
                        for m in ("probe_tpu", "probe_tpu2", "probe_tpu17", "probe_tpu21"))
    o1, o2, o17, o21 = (importlib.import_module(f"h2r_old.probes.{m}")
                        for m in ("probe_tpu", "probe_tpu2", "probe_tpu17", "probe_tpu21"))
    before, before_old = set(K.BUILD_LOG), set(old_k.BUILD_LOG)
    K.build_probes()
    old_k.build_probes()
    libs = {}
    for kernel, source, variants in ((K.ONEHOT_COUNT, "probe_units.cu", COUNT_VARIANTS),
                                     (K.MMA_ACCUM, "probe_mma_accum.cu", MMA_VARIANTS),
                                     (K.INT8_MMA, "probe_int8_mma.cu", INT8_VARIANTS),
                                     (K.DFA_STEP, "probe_dfa_step.cu", DFA_VARIANTS)):
        dirs = {name: variant_csrc(K, f"{kernel.name}_{name}", edits)
                for name, edits in variants.items()}
        with ThreadPoolExecutor(len(dirs)) as pool:
            jobs = {name: pool.submit(K._build_library, (source,), (kernel,), K.PROBE_HEADERS,
                                      None, d) for name, d in dirs.items()}
            libs[kernel.name] = {name: j.result() for name, j in jobs.items()}
    keys, okeys = sorted(set(K.BUILD_LOG) - before), sorted(set(old_k.BUILD_LOG) - before_old)
    rec = {}
    for name, fn in (("onehot_count", "onehot_count_kernel"), ("mma_accum", "mma_accum"),
                     ("int8_mma", "int8_"), ("dfa_step", "dfa_kernel")):
        rec[f"{name} ptxas"] = ptxas_of(K, keys, name)
        rec[f"{name} ptxas_old"] = ptxas_of(old_k, okeys, name)
        for ln in rec[f"{name} ptxas"] + rec[f"{name} ptxas_old"]:
            print(ln, flush=True)
        rec[f"{name} sass"] = sass_counts(K, keys, fn)
        rec[f"{name} sass_old"] = sass_counts(old_k, okeys, fn)

    def turns(name, first, second, labels):
        t = [cs.time_ms(f, flush, device_only=True) for f in (first, second, second, first)]
        print(f"{name}: {labels[0]} {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, {labels[1]} "
              f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms ({labels[0]}, {labels[1]}, "
              f"{labels[1]}, {labels[0]}); card {card}", flush=True)
        return {labels[0]: [t[0]["median"], t[3]["median"]],
                labels[1]: [t[1]["median"], t[2]["median"]], "iqr": [x["iqr"] for x in t]}

    c = p2.bytes_(*p2.F_SHAPE, seed=5, dev=dev)
    want = p2.onehot_count_plain(c)
    check(cs, "onehot_count", p2.onehot_count(c), want)
    check(cs, "onehot_count old", o2.onehot_count(c), want)
    rec["onehot_count old/new"] = in_turns(cs, f"onehot_count {list(c.shape)}",
                                           lambda: o2.onehot_count(c), lambda: p2.onehot_count(c),
                                           flush, card)
    rec["onehot_count library"] = turns(
        "onehot_count vs the range test", lambda: p2.onehot_count(c),
        lambda: ((c >= 0) & (c < 256)).sum(0, dtype=torch.int32, keepdim=True),
        ("kernel", "library"))
    for vname, vlib in libs["onehot_count"].items():
        got = torch.empty_like(want)

        def run_var(vlib=vlib, got=got):
            if vlib.h2r_onehot_count(c.data_ptr(), got.data_ptr(), c.shape[0], c.shape[1],
                                     K._stream(c)):
                raise RuntimeError("onehot_count variant: launch failed")
            return got

        if vname not in TIMING_ONLY:
            check(cs, f"onehot_count {vname}", run_var(), want)
        rec[f"onehot_count {vname}"] = turns(f"onehot_count variant {vname}",
                                             lambda: p2.onehot_count(c), run_var,
                                             ("kernel", "variant"))
    for shape in (p21.SHAPE, p21.BIG):
        a, b = p21.inputs(shape, "ints", seed=2, dev=dev)
        want = p21.mma_accum_plain(a, b)
        check(cs, "mma_accum", p21.mma_accum(a, b), want)
        check(cs, "mma_accum old", o21.mma_accum(a, b), want)
        rec[f"mma_accum {list(shape)} old/new"] = in_turns(
            cs, f"mma_accum {list(shape)}", lambda: o21.mma_accum(a, b),
            lambda: p21.mma_accum(a, b), flush, card)
        if shape == p21.SHAPE:  # the host's share: the tensor maps are encoded each call
            from halo2_regex_tpu_torch.probes import harness
            fns = {"new": lambda: p21.mma_accum(a, b), "old": lambda: o21.mma_accum(a, b),
                   "library": lambda: p21.mma_accum_library(a, b)}
            order = ["new", "old", "library", "library", "old", "new"]
            us = [harness.host_us(dev, fns[k], 200) for k in order]
            host = {k: [u for o, u in zip(order, us) if o == k] for k in fns}
            print(f"mma_accum {list(shape)} host us a call over 200 back-to-back calls, then "
                  f"one synchronize (new, old, library, library, old, new): {host}; card {card}",
                  flush=True)
            rec[f"mma_accum {list(shape)} host_us_a_call"] = host
        rec[f"mma_accum {list(shape)} library"] = turns(
            f"mma_accum {list(shape)} vs the library", lambda: p21.mma_accum(a, b),
            lambda: p21.mma_accum_library(a, b), ("kernel", "library"))
        for vname, vlib in libs["mma_accum"].items():
            got = torch.empty_like(want)

            def run_var(vlib=vlib, got=got, a=a, b=b):
                NI, NL, M, K_, N = p21._check(a, b)
                if vlib.h2r_mma_accum(a.data_ptr(), b.data_ptr(), got.data_ptr(), NI, NL, M, N,
                                      K_, K._stream(a)):
                    raise RuntimeError("mma_accum variant: launch failed")
                return got

            if vname not in TIMING_ONLY:
                check(cs, f"mma_accum {vname}", run_var(), want)
            rec[f"mma_accum {list(shape)} {vname}"] = turns(
                f"mma_accum {list(shape)} variant {vname}", lambda: p21.mma_accum(a, b),
                run_var, ("kernel", "variant"))
    for i, n in enumerate(p17.WIDTHS):
        a, b = p17.inputs(n, n, n, seed=n, probe=i == 0, dev=dev)
        want = p17.int8_mma_plain(a, b)
        check(cs, "int8_mma", p17.int8_mma(a, b), want)
        check(cs, "int8_mma old", o17.int8_mma(a, b), want)
        rec[f"int8_mma {n}^3 old/new"] = in_turns(cs, f"int8_mma {n}^3", lambda: o17.int8_mma(a, b),
                                                  lambda: p17.int8_mma(a, b), flush, card)
        rec[f"int8_mma {n}^3 library"] = turns(
            f"int8_mma {n}^3 vs torch._int_mm", lambda: p17.int8_mma(a, b),
            lambda: torch._int_mm(a, b), ("kernel", "library"))
        for vname, vlib in libs["int8_mma"].items():
            got = torch.empty_like(want)

            def run_var(vlib=vlib, got=got, a=a, b=b, n=n):
                scratch = torch.empty(vlib.h2r_int8_mma_scratch(a.data_ptr(), n, n, n),
                                      dtype=torch.int8, device=dev)
                if vlib.h2r_int8_mma(a.data_ptr(), b.data_ptr(), got.data_ptr(),
                                     scratch.data_ptr(), n, n, n, K._stream(a)):
                    raise RuntimeError("int8_mma variant: launch failed")
                return got

            if vname not in TIMING_ONLY:
                check(cs, f"int8_mma {vname}", run_var(), want)
            rec[f"int8_mma {n}^3 {vname}"] = turns(f"int8_mma {n}^3 variant {vname}",
                                                   lambda: p17.int8_mma(a, b), run_var,
                                                   ("kernel", "variant"))
    T = p1.table().to(dev)
    classes, tk = p2.class_inputs(dev=dev)
    # the probes' own widths (their scripts' inputs): k6, C, D, fullwidth, select
    p3 = importlib.import_module("halo2_regex_tpu_torch.probes.probe_tpu3")
    widths = [("k6", T, p1.bytes_(256, 256, seed=6, dev=dev), "onehot_mma", False, "gather",
               None)]
    widths += [(f"C {tb}", T, p1.bytes_(p2.LB, tb, seed=tb, dev=dev), "onehot_mma", True,
                "gather", None) for tb in p2.C_TB]
    widths.append(("D", tk, p1.bytes_(p2.LB, p2.D_TB, seed=p2.D_TB + 1, dev=dev), "class_mma",
                   True, "gather", classes))
    widths += [(f"{name} {tb}", T, p1.bytes_(p3.LB, tb, seed=tb + 11, dev=dev), "onehot_mma",
                True, pick, None)
               for name, pick, tbs in (("fullwidth", "gather", p3.FULL_TB),
                                       ("select", "sum", p3.SELECT_TB)) for tb in tbs]
    for name, t_, c, form, tm, pick, cl in widths:
        want = p1.dfa_step_plain(t_, c, form, tm, pick, cl)
        check(cs, f"dfa_step {name}", p1.dfa_step(t_, c, form, tm, pick, cl), want)
        check(cs, f"dfa_step {name} old", o1.dfa_step(t_, c, form, tm, pick, cl), want)
        rec[f"dfa_step {name} {list(c.shape)} old/new"] = in_turns(
            cs, f"dfa_step {name} {list(c.shape)} {form} {pick}",
            lambda: o1.dfa_step(t_, c, form, tm, pick, cl),
            lambda: p1.dfa_step(t_, c, form, tm, pick, cl), flush, card)
    TB, LB = p2.BIG
    cb = p1.bytes_(LB, TB, seed=7, dev=dev)  # probe_tpu2's from: batch lines' bytes
    for form in ("onehot_mma", "class_mma"):
        t_, cl = (tk, classes) if form == "class_mma" else (T, None)
        for pick in ("gather", "sum"):
            want = p1.dfa_step_plain(t_, cb, form, True, pick, cl)
            check(cs, f"dfa_step {form} {pick}", p1.dfa_step(t_, cb, form, True, pick, cl), want)
            check(cs, f"dfa_step {form} {pick} old", o1.dfa_step(t_, cb, form, True, pick, cl),
                  want)
            lab = f"dfa_step {form} {pick} {TB}x{LB}"
            rec[f"{lab} old/new"] = in_turns(
                cs, lab, lambda: o1.dfa_step(t_, cb, form, True, pick, cl),
                lambda: p1.dfa_step(t_, cb, form, True, pick, cl), flush, card)
            for vname, vlib in libs["dfa_step"].items():
                if vname.startswith("class_") and form != "class_mma":
                    continue
                got = torch.empty_like(want)

                def run_var(vlib=vlib, got=got, t_=t_, cl=cl, form=form, pick=pick):
                    if vlib.h2r_dfa_step(t_.data_ptr(), None if cl is None else cl.data_ptr(),
                                         cb.data_ptr(), got.data_ptr(), TB, LB, 1,
                                         p1.FORMS.index(form), p1.PICKS.index(pick),
                                         t_.shape[0] if form == "class_mma" else 1,
                                         K._stream(cb)):
                        raise RuntimeError("dfa_step variant: launch failed")
                    return got

                if vname not in TIMING_ONLY:
                    check(cs, f"dfa_step {vname}", run_var(), want)
                rec[f"{lab} {vname}"] = turns(
                    f"{lab} variant {vname}", lambda: p1.dfa_step(t_, cb, form, True, pick, cl),
                    run_var, ("kernel", "variant"))
    return rec


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="directory of the earlier halo2_regex_tpu_torch/ package "
                    "(every part; marker runs without it, its variants alone)")
    ap.add_argument("--only",
                    default="pack,fb,walls,marker,lookup,units,wide,scan,bitop,carry,gather",
                    help="comma-separated parts to run (default: all)")
    args = ap.parse_args()
    parts = set(args.only.split(","))
    if parts - {"marker", "wide", "scan", "bitop", "carry", "gather"} and not args.old:
        ap.error("--old is needed for the pack, fb, walls, lookup and units parts")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.utils import profiling

    # both packages build into the checkout's build root
    os.environ.setdefault("H2R_TORCH_BUILD_DIR", str(K.build_root()))
    pk = None
    if args.old:
        old, old_k = import_old(Path(args.old).resolve())
        pk = Pkgs(h2r, old, K, old_k)
    dev = torch.device("cuda")
    card = cs.smi()
    print(f"card: {card}", flush=True)
    rec: dict = {"card": card, "versions": cs.versions()}
    # the write flush (a zeroed buffer past the L2: dirty lines), which
    # this script's pairs were timed after before chip_smoke and the probes
    # took the reading flush; ReadFlush(flush) gives that one
    flush = profiling.L2Flush(dev, write=True)
    corpora = ({Lc: cs.bench_corpus(cs.B, Lc) for Lc in (cs.L, cs.L_UNPADDED)}
               if parts & {"pack", "fb", "walls"} else {})
    out = {}
    if "pack" in parts:
        out["pack"] = pack_ab(pk, cs, dev, card, flush, corpora)
    if "fb" in parts:
        out["fb_only"] = fb_ab(pk, cs, dev, card, flush, corpora)
    if "walls" in parts:
        out["walls"] = walls_ab(pk, cs, dev, card, flush, corpora)
    if "marker" in parts:
        out["marker"] = marker_ab(pk, cs, dev, card, flush)
    if "lookup" in parts:
        out["lookup"] = lookup_ab(pk, cs, dev, card, flush)
    if "units" in parts:
        out["units"] = units_ab(pk, cs, dev, card, flush)
    if "wide" in parts:
        out["wide"] = wide_ab(pk, cs, dev, card, flush)
    if "scan" in parts:
        out["scan"] = scan_ab(pk, cs, dev, card, flush)
    if "bitop" in parts:
        out["bitop"] = bitop_ab(pk, cs, dev, card, flush)
    if "carry" in parts:
        out["carry"] = carry_ab(pk, cs, dev, card, flush)
    if "gather" in parts:
        out["gather"] = gather_ab(pk, cs, dev, card, flush)
    rec["ab"] = out
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_ab.json", "w") as f:
        json.dump(rec, f, indent=1)

    def pairs_of(d):  # the medians of every pair in d, nested as in d
        got = {}
        for k, v in d.items():
            if isinstance(v, dict):
                sub = ({key: v[key] for key in ("old", "new", "kernel", "variant", "library")
                        if key in v}
                       if "new" in v or "variant" in v or "library" in v else pairs_of(v))
                if sub:
                    got[k] = sub
        return got

    return {"ok": True, "card": card, "ab": pairs_of(out)}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
