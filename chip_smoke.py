"""Smoke run of the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``halo2_regex_tpu_torch.BitplaneMatcher(model, columns=...)`` on the
zk-email ``from:`` header model at bench.py's shape (B=32768 strings x
L=1024 bytes, bench.py's synthetic corpus, seed 0), the table-driven
``PallasMatcher`` on that corpus, on BASELINE configs[3] and on the
40-word dictionary model, the portable scan ``BatchMatcher`` on the
corpus and on configs[3], the corpus-scan CLI and the device-expand
``ScanJob``, through each of these paths:

  witness   columns="witness" (bench.py's headline): K1 qpack, K2 scan,
            K3 post;
  match     columns="match" (corpus filtering): qpack, scan, fb_only;
  full      columns="full" (the default RegexResult) and extraction
            serving (``extract_runs`` on its masked columns, as
            benchmarks/run_benchmarks.py's extract-serving rows): qpack,
            scan, post_planes;
  L=1000    the witness path on the model at max_chars_size=1000 (L_pad
            1024): pack_raw replaces qpack;
  pallas_large  BASELINE configs[3] at its published size (a 1000-state
            random table, B=64 x L=65536, run_benchmarks.py:352-396's data):
            PallasMatcher(max_pairs=4096), segmented into 16 x 4096 as in
            JAX, one pass over L on the card: table_scan and table_fsm in
            their chunked forms (speculate + repair; maps, carries,
            replay), table_tag;
  pallas_from  PallasMatcher on the from: corpus in batch mode (bench.py's
            pallas leg, bench.py:195-214);
  tiled_witness, tiled_match  the witness and match paths on the
            host-pretiled corpus (``tile_corpus``, input_layout="tiled"):
            tpack, scan, then post_tiled or fb_only;
  pallas_dict  PallasMatcher on the 40-word dictionary model
            (``zoo.dictionary_model``: 211 pairs, so ``auto`` resolves to
            the monolithic mode) over a seeded corpus: one table_flat
            launch (also checked with its table read from global memory);
  xla       ``best_matcher(model, backend="xla")`` (the portable scan,
            ``BatchMatcher``: halo2_regex_tpu/__init__.py:23's usage) on
            the from: corpus: table_scan (serial) and torch ops;
  xla_large  ``BatchMatcher`` on BASELINE configs[3] at its published size
            (run_benchmarks.py:385's fallback): table_scan (chunked);
  device_expand  ``ScanJob(device_expand=True)`` over cli_scan's file with
            the match and tiled match matchers: each chunk's raw bytes
            uploaded once, the rows gathered on the card (``expand_rows``,
            ``tile_corpus_device``);
  cli_scan  ``cli.main(["scan", ...])`` in process over a 100,000-line
            file (the first 50,000 bench.py strings, each split at its
            \r\n into a filler line and a from: line), batch 32768, both
            input layouts;
  knob paths  ``KNOB_PATHS``: the from: model under each knob value off
            the default (emit direct / kdecode / planes, post="xla" for
            witness and full, fuse_pack, class stage off and onehot,
            match with en_pack off, unroll 1, 2, 4, 8): post_direct,
            decode, scan_fpack and the pack, scan and post kernels' modes;
  scan_planes  ``BitplaneMatcher.scan_planes(bits, d)`` for each def of
            the 3-def email model (from, to, subject) at L=1024: scan_def;
  prover    the prover's flow on the from: corpus: the witness on the card
            (qpack, scan, post), ``expand_witness`` and
            ``check_witness_batch`` on the host, ``save_witness`` /
            ``load_witness`` on 256 rows, one matching row's hand-off
            dump (``verify_handoff`` and the C++ ``handoff_check``); the
            ``compact=False`` full result (qpack, scan, post_planes)
            through the checker too;
  parallel  the sharded matchers on a mesh of the one card repeated
            (``[cuda:0] * 4``: the shards run one after another):
            ``DistributedMatcher`` xla and pallas (4 x 1) and
            ``SeqShardedMatcher`` (1 x 4) on the from: corpus (table_scan;
            table_tag and table_fsm for pallas),
            ``SpeculativeSeqMatcher(per_shard="pallas")`` (1 x 4) on
            configs[3] and on the permutation DFA (table_scan), and
            ``python -m halo2_regex_tpu_torch.parallel.launch`` at world
            size 1 over nccl on cli_scan's file (a subprocess);
  probes    the serial-scan probes of tools/ (``probes/``): the ``run``
            of ``halo2_regex_tpu_torch.probes.probe_tpu9`` (loop_floor,
            slab_scan: chunked, and serial at [65536, 64]),
            ``.probe_tpu20`` (bitop_table, then bitop_scan: table and
            serial) and ``.probe_tpu56`` (chains: fixed and serial),
            which their ``python -m`` entry points call, at [10]'s widths;
  table probes  the table-kernel probes of tools/ (``probes/``): the
            ``run`` of ``.probe_tpu`` (lane_gather, dfa_step),
            ``.probe_tpu2`` (nop, dfa_step time-major, the lone gather
            chain, onehot_count; with the from: batch, B=32768 x L=1024,
            for dfa_step lookup, class_mma and onehot_mma), ``.probe_tpu3``,
            ``.probe_tpu17`` (int8_mma) and ``.probe_tpu18``
            (slab_anatomy) at their own widths;
  emit probes  the emission and decode probes of tools/ (``probes/``):
            the ``run`` of ``.probe_tpu47`` (tile_move: the int32 tile
            transpose and copy), ``.probe_tpu48`` (l4_pack: the direct
            [B, L] emission; the copy, then the library's decode),
            ``.probe_tpu64`` (tile_move and every l4_pack form at [64,
            1024, 128]; on the from: batch the torch tails, B14 and
            field_decode mma_pack; qpack alone) and ``.probe_tpu68``
            (field_decode mma_select and swap beside B14 on the from:
            batch's g4; the witness pipeline with each decode form in turns
            with the shipped bytes, kdecode and direct witness);
  t2 probes  the launch, accumulate, carry, class-chain and configs[3]
            table-step probes of tools/ (``probes/``): the ``run`` of
            ``.probe_tpu21`` (mma_accum), ``.probe_tpu20``'s D and E
            (``run_de``: mma_accum, bitop_carry), ``.probe_tpu6`` (k1
            loop_floor, k2 dfa_wide, k3 slab_anatomy, k4 class_chain),
            ``.probe_tpu67`` (a launch's cost past its bytes: chains of
            tile_move copies; the witness at B = 32768, 65536, 131072),
            ``.probe_tpu7``, ``.probe_tpu28``, ``.probe_tpu30``,
            ``.probe_tpu31`` and ``.probe_tpu32`` (dfa_wide), and the
            widened step at configs[3]'s batch beside B8's table scan
            (``probe_tpu28.configs3_lines``);
  marker probes  the marker-stream probes of tools/ (``probes/``): the
            ``run`` of ``.probe_tpu57`` (B and C: marker_match serial and
            chunked, its plain version and K2 on the from: batch at
            B=32768 and 4096 x L=1024; D: the from: model at 4096 x 65536,
            BitplaneMatcher witness beside PallasMatcher; E: the 200-word
            model's witness at 32768 x 1024 in two plans) and
            ``.probe_tpu61`` (C: the same verdicts and K2 by the slope of
            chained calls).

and proves on the card that:

  1. the card is there (name and power limit from nvidia-smi, versions);
  2. the CUDA kernels build from the sources in this checkout (nvcc, one
     library per bitplane path and one for the table kernels, every
     source compiled at once);
  3. the models compile and the corpora are built;
  4. each of the sixteen kernels of the matchers (thirty-four with [10]'s
     four probe kernels, [11]'s six, [12]'s three, [13]'s four and [14]'s
     one), and
     each knob mode of the pack, scan and post kernels, is bit-exact
     against its plain PyTorch version on the same inputs at that size
     ([13]'s mma_accum within its stated tolerance on N(0, 1) inputs;
     scan_def also against the fused
     scan's slices; the quad-word pack in both layouts and every mode:
     pack_raw at L=1000 and, in each mode, on the L=1024 raw quad rows,
     tpack in each class-stage mode) (the table kernels on the
     whole of configs[3] and of the from: corpus, and on a middle window
     of its first 4096 strings with carries on both sides, where the FSMs
     run in chunks; the from: planes must not be all zeros, as configs[3]'s
     tag and FSM planes are: it has no pairs; the scan and FSMs in both
     their forms, the one-pass FSMs also with their backward codes in a
     global scratch; the chunked scan's repaired positions equal its torch
     twin's at configs[3] and on a 1000-state DFA that never resyncs (every
     byte permutes the states: every speculative chunk is repaired) at
     B=64 x L=65536); the tag, scan and FSM kernels also on a def of 7511
     pairs (past the 4096 pairs the tag kernel stages in shared memory)
     and the flat kernel on nine defs (two groups of its scan), each model
     then run once through its matcher (``beyond_staging``); the table
     scan also on the portable scan's own tables (the class map of
     ``model.transition``'s rows) at both of its paths' shapes;
  5. each path, driven once through the matcher with the launch counts
     reset just before it, launched each of its kernels as often as
     ``kernels.path_launches`` says (once, three times for a chunked post;
     the table paths as ``kernels.table_path_launches``: one pass over L,
     the chunked scan two launches, the chunked FSMs three; the portable
     paths as ``kernels.scan_path_launches``: the table scan alone) and no
     other (configs[3]'s launches per call and repaired positions are
     printed), and equals its
     plain pipeline on the card (every output, dtypes included); a subset
     equals the numpy oracle (256 strings, 8 for configs[3]); for
     extraction serving the runs equal the oracle's extracted substrings;
     pallas_from and pallas_dict equal BitplaneMatcher(compact=False) on
     every field, pallas_from at B=4096 its plain pipeline; xla equals
     pallas_from and BitplaneMatcher(compact=False) on every field, and
     xla and xla_large equal the C++ host oracle
     (``native.match_substrs_native``) on every string of the batch; the
     tiled paths equal the [B, L] paths on every key; cli_scan's counters are
     equal between the layouts and count the match path's verdicts on the
     same packed lines, and the device-expand jobs count what the
     host-packed jobs count; each knob path equals its plain pipeline, the
     default path of its column set on every key and the oracle's
     subset; scan_planes the oracle's states of each def;
  6. timings with CUDA events (2 warm-ups, 10 timed runs, median and
     IQR; L2 flushed before each timed run): each kernel's device time
     beside its plain version's and its bound (the larger of its bytes
     over 3.35 TB/s and its int32 operations over the card's int32 rate),
     each path end to end as a caller sees one call (host launch overhead
     included) with its peak device memory (and, for the table paths, the
     host's enqueue time), the B=4096 latency of match, extraction serving
     and pallas_from, and the plain pipelines (PLAIN_WARMUP +
     PLAIN_ITERS runs); the tiled
     and [B, L] walls side by side at B=32768 and B=4096 with the host's
     tile_corpus time per batch; pallas_dict beside its split-mode
     equivalent (max_pairs=4096); the portable paths' walls (xla at
     B=32768 and B=4096, xla_large) each beside PallasMatcher's on the
     same inputs, with their plain pipelines and the table scan under
     them; cli_scan's bytes per second per layout, and the ScanJob's
     host-packed and device-expand bytes per second;
     the knob paths' kernels and walls (their plain scans and pipelines
     over 1 run, seconds each);
  8. the prover's flow: its launches as the witness and full paths'; the
     expanded witness equals the C++ oracle's columns of the whole batch
     (``native.native_result``; dtypes as JAX's ``expand_witness``: the
     three sums int64) and the card's full result equals them with
     dtypes; the checker's verdicts on the expanded witness, on the
     oracle's columns, on the full result and ``match_ok`` are equal;
     the npz round-trips; the hand-off dump of the card row equals the
     oracle row's, verifies, passes ``handoff_check`` and a tampered copy
     fails it; ``expand_witness`` and ``check_witness_batch`` host times
     (median and IQR of 3);
  9. each sharded matcher, driven once with the launch counts reset,
     launched the table kernels as its shards' calls say (speculation:
     its rounds x shards) and equals the unsharded card matcher on every
     field, dtypes included (``DistributedMatcher``'s stats equal the
     sums of the unsharded result, int32); the permutation DFA needs all
     4 rounds; launch's totals equal cli_scan's; walls in turns with the
     unsharded matcher (unsharded, sharded, sharded, unsharded) and
     launch's bytes/s in turns with ``ScanJob`` on ``BatchMatcher``;
 10. the probe scripts' runs, driven with the launch counts reset,
     launched every probe kernel and no other; in each measurement one
     call launched its kernel once and nothing else (every count read
     around it), and its line names this card; each probe kernel is
     bit-exact against its plain version (int32, tolerance 0) at
     loop_floor (slab 1 and 8) [1024, 256], [1024, 1024], [65536, 64];
     slab_scan [1024, 256], [65536, 64] (both in their chunked form, and
     at [65536, 64] in their serial form too); bitop_scan n_ops 96, 192, 384,
     768 at [1024, 12, 8, 128] from seeded start planes (its outputs not
     all zero); chains C = 1, 2, 4 at blocks of 32 and of 1024 threads;
     each timed (2 + 10 runs; ns and cycles a serial step at 1.98 GHz;
     the plain version once; ``torch.cumsum`` beside loop_floor), and
     K2's and configs[3]'s table scan's steps set beside those curves (the
     serial forms' steps, each with its launches a call); ptxas' log
     beside the library shows no spills in the chunked loop_floor and slab
     kernels, and their SASS no local memory (LDL, STL);
 11. the table-kernel probe scripts' runs, driven with the launch counts
     reset, launched every table probe kernel and no other; each
     measurement as in [10] (an int8_mma call launches twice: its staging
     pass, then its product kernel), each kernel bit-exact against its plain
     version (int32, tolerance 0): lane_gather (k3, k4, k5, k1, 1024-step
     chains at [256, 128] and [1, 128], the row in shared memory and in
     registers, each chain by squaring and serially), dfa_step (lookup, onehot_mma with both picks, class_mma;
     batch- and time-major, the probes' widths and the from: batch),
     slab_anatomy (1, 2, 4 outputs, from: tables, [1024, 4096]), nop,
     onehot_count and int8_mma (128^3, 4096^3); library calls beside them
     (``torch.gather``, ``x + 1``, ``torch._int_mm``) and the scripts'
     torch lines (the copy rate, bf16 products) timed; the lone chain set
     beside configs[3]'s table-scan chain step of this run; the SASS holds
     wgmma (HGMMA) in the four tensor-core instances of dfa_step and no
     mma.sync (HMMA), integer wgmma (IGMMA) in both tile widths of
     int8_mma and at least 256 compares a byte in onehot_count (an HSET2
     or HSETP2 two); ptxas' log beside the library shows no spills in
     onehot_count, int8_mma (its staging pass and product kernel),
     dfa_step or lane_gather's pow form, and that form's SASS no local
     memory (LDL, STL);
 12. the emission and decode probe scripts' runs, driven with the launch
     counts reset, launched every emit probe kernel and, of the others,
     only the matcher kernels their witness fronts and walls run; each
     measurement as in [10], each kernel bit-exact against its plain
     version (int32, tolerance 0): tile_move (copy and transpose at [8, 8,
     1024, 128] and [64, 1024, 128]; ``x.clone()`` and
     ``x.transpose(-2, -1).contiguous()`` beside them), l4_pack (permute
     at [8, 8, 1024, 128], every form at [64, 1024, 128]), field_decode
     (mma_pack, mma_select, swap on the from: batch's g4, B=32768 x
     L=1024), B14 decode and qpack there too; every decode form equals
     the torch tail's columns and B14's on the same g4; each probe_tpu68
     pipeline's witness keys equal the shipped witness's; B14's ms, each
     decode form's and each witness wall are logged side by side; the
     SASS holds HMMA in the four mma instances of the emit kernel and in
     none of the others;
 13. the t2 probe scripts' runs, driven with the launch counts reset,
     launched every t2 probe kernel and, of the others, only loop_floor,
     slab_anatomy, tile_move, the witness kernels (qpack, scan, post) and
     the table scan; each measurement as in [10], each kernel against its
     plain version: int32 outputs bit-exact (bitop_carry at one position
     a chunk from a zero and a seeded start and at every position, each in
     its reduce and serial forms;
     class_chain in both forms at [64, 128] and [1024, 32768]; dfa_wide
     lookup, onehot_mma and count at the probes' (K, S) from 32 x 256 to
     1024 x 128 and at configs[3]'s B=64 x L=65536, where B8's table scan
     equals it too and the chunked lookup repairs as many positions as its
     twin, ``lookup_chunks_plain``), mma_accum bit-exact on integer inputs and within 2e-5
     x sum |a b| on N(0, 1) ones ([4, 2, 128, 128], [4, 8, 1024, 1024]);
     the library calls beside them (``torch.matmul(a, b).float().cumsum(1)``,
     ``((c[..., None] >= b) * delta).sum(-1)``, ``torch.cumsum``,
     ``x.clone()``); probe_tpu67's chains give a launch's wall and device
     slope and its cost past its bytes, and its witness batches agree on
     the rows they share; the SASS holds HGMMA (wgmma) in mma_accum and in
     every instance of dfa_wide's product, no HMMA there and neither in its
     lookup, LOP3 in bitop_carry's serial kernel, 16-byte loads (LDG.E.128)
     in its reduce kernel and no local memory (LDL, STL) there, and ptxas
     reports no spills in mma_accum, dfa_wide or the reduce kernel;
 14. the marker probe scripts' runs, driven with the launch counts reset,
     launched marker_match and, of the others, only the matcher kernels
     they reuse (pack_raw, scan, qpack, post, decode, the table kernels);
     each marker_match measurement as in [10], bit-exact against its plain
     version (int32, tolerance 0) serial and at every chunk length, at
     B=32768 and 4096 x L=1024, and every verdict equal to Python re's;
     K2 with the probe's plan bit-exact against its plain scan; D's two
     matchers and E's two witness plans equal the C++ oracle's match_ok
     and masked characters on 64 rows; the verdict's forms are logged
     beside K2 and the match path's wall of this run, and probe_tpu61's
     chain slopes (rounds under the copy-rate floor discarded) beside them.

Prints the wall seconds of each phase, one JSON line of per-kernel
results (the knob modes of a kernel under its ``modes``, a probe
kernel's widths under its ``configs``), then the nvidia-smi line, then
as its last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero without that line, as does a machine without CUDA.  A full
record goes to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, L = 32768, 1024
L_UNPADDED = 1000  # L_pad 1024: the raw-quads pack (B5) path
B_LATENCY = 4096  # the suite's latency rows
WARMUP, ITERS = 2, 10
PLAIN_WARMUP, PLAIN_ITERS = 0, 2  # each plain version ran before [6] ([4], [5])
ORACLE_N = 256
B3, L3, S3 = 64, 65536, 1000  # BASELINE configs[3] (run_benchmarks.py:352-396)
ORACLE_N3 = 8
N_CLI = 50000  # bench.py strings in cli_scan's file: two lines each
LAUNCH_REPEAT = 32  # launch's file: cli_scan's, this many times over
# bounds: H100 SXM HBM3 rate; int32 rate = 132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock (Hopper white paper); half2 instructions (HSET2,
# HADD2, HFMA2) = 132 SMs x 128 lanes x 1.98 GHz, the white paper's fp16
# rate outside the tensor cores (twice float32's 67 TFLOP/s, two halves an
# instruction)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HALF2_INSTRS_PER_S = 132 * 128 * 1.98e9
# [10]'s widths: the probe's own, the bitplane scan's word count (B=32768:
# 1024 words) and configs[3]'s strings x L (the table scan's serial shape)
FLOOR_WIDTHS = ((1024, 256), (1024, 1024), (L3, B3))
SLAB_WIDTHS = ((1024, 256), (L3, B3))
BITOP_L, BITOP_NWS = 1024, 8  # the probe's [L, 12, 8, 128]: B=32768 strings
# K2's circuit-only variant (the scan loop reading its input from shared
# memory): cycles a position on an H100 80GB HBM3 at 700 W, by kernel_ab.py
# in the tree that gave the scan its cp.async ring (git history; PERF.md
# §6); quoted beside [10]'s curves, not measured here
K2_CIRCUIT_ONLY_CYCLES = 197
WIN0, WIN_LS = 256, 512  # the B=4096 from: window checks: [256, 768) of L
EXTRACT = dict(max_runs=4, max_len=32)  # run_benchmarks._extract_serving
KEYS = ("states", "all_substr_ids", "masked_characters", "flags", "mask",
        "accepted", "has_dead", "match_ok")
# the knob paths on the from: model: (columns, BitplaneMatcher knobs); each
# equals the default-knob path of its column set on every key
KNOB_PATHS = {
    "witness_direct": ("witness", {"emit": "direct"}),
    "witness_kdecode": ("witness", {"emit": "kdecode"}),
    "witness_planes": ("witness", {"emit": "planes"}),
    "witness_post_xla": ("witness", {"post": "xla"}),
    "full_post_xla": ("full", {"post": "xla"}),
    "witness_fuse_pack": ("witness", {"fuse_pack": True}),
    "witness_class_off": ("witness", {"class_stage": False}),
    "witness_onehot": ("witness", {"class_stage": "onehot"}),
    "match_en_off": ("match", {"en_pack": False}),
    **{f"witness_unroll{u}": ("witness", {"unroll": u}) for u in (1, 2, 4, 8)},
}
ORACLE_KEYS = {"witness": ("states", "all_substr_ids", "masked_characters", "mask", "match_ok"),
               "match": ("accepted", "has_dead", "match_ok")}


PHASE_S: dict = {}  # wall seconds a phase: the time before each log line, by its "[N]" tag
_LAST_LOG = [time.perf_counter()]


def log(msg: str) -> None:
    now = time.perf_counter()
    tag = msg.split(" ", 1)[0] if msg.startswith("[") else "other"
    PHASE_S[tag] = PHASE_S.get(tag, 0.0) + now - _LAST_LOG[0]
    _LAST_LOG[0] = now
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def versions() -> dict:
    from halo2_regex_tpu_torch.ops import kernels

    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        nv = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout
        out["nvcc"] = nv.strip().splitlines()[-1]
    except (RuntimeError, subprocess.CalledProcessError) as e:
        out["nvcc"] = f"unavailable ({e})"
    try:
        import triton

        out["triton"] = triton.__version__
    except ImportError:
        out["triton"] = "not installed"
    return out


def bench_corpus(n: int, length: int, seed: int = 0):
    """bench.py's synthetic from: corpus (bench.py:122-135), same rng calls."""
    rng = np.random.default_rng(seed)
    chars = np.zeros((n, length), np.uint8)
    lengths = np.zeros((n,), np.int32)
    domains = [b"gmail.com", b"x.yz", b"sub.domain-x.org"]
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    alpha_sp = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    for i in range(n):
        name = rng.choice(alpha, size=8).tobytes()
        filler_len = int(rng.integers(0, max(1, length - 96)))
        filler = rng.choice(alpha_sp, size=filler_len).tobytes()
        s = filler + b"\r\nfrom:" + name + b"@" + domains[i % 3] + b"\r\n"
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


def time_ms(fn, flush: torch.Tensor, device_only: bool, warmup: int = WARMUP,
            iters: int = ITERS) -> dict:
    """Median and IQR of ``fn`` in ms from CUDA events; the L2 cache is
    flushed (a write larger than it) before each run, outside the window.
    ``device_only``: a ~1 ms device spin is queued before the window, so
    the host has launched ``fn`` before the card reaches the start event
    and the window holds device time only (no host launch overhead).
    Without it the window is what one call costs a caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in pairs])
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "iqr": [float(q1), float(q3)],
            "all": [float(x) for x in ms], "runs": iters}


def dict_corpus(n: int, length: int, words, seed: int = 2):
    """The pallas_dict corpus: random lowercase bytes, lengths spread over
    [0, length]; every third string is ``tag:<word>\r\n`` (a match that
    extracts the word), every third after it the same with a wrong ending
    (ids light up, no match); the bytes past each length stay random."""
    rng = np.random.default_rng(seed)
    chars = rng.integers(97, 123, size=(n, length)).astype(np.uint8)
    lengths = rng.integers(0, length + 1, size=n).astype(np.int32)
    for i in range(n):
        if i % 3 == 2:
            continue
        s = b"tag:" + words[int(rng.integers(0, len(words)))] + (b"\r\n" if i % 3 == 0 else b"\r")
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


def config3(h2r):
    """BASELINE configs[3] as run_benchmarks.py:360-391 makes it: the
    1000-state table over bytes 32..126, then the B3 x L3 chars, drawn in
    that order from one default_rng(0)."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs

    rng = np.random.default_rng(0)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S3 - 1)
    line = 3
    for c in range(32, 127):
        for s in range(S3):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, S3)))
            line += 1
    model = h2r.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[])],
                                             max_chars_size=L3)
    chars = rng.integers(32, 127, size=(B3, L3)).astype(np.uint8)
    return model, chars, np.full((B3,), L3, np.int32)


def permutation_dfa(h2r):
    """configs[3]'s shape with a DFA that never resyncs: 1000 states over
    bytes 32..126, each byte a random permutation of the states (so two
    walkers from different states never meet, and every guess of the
    chunked scan fails), and B3 x L3 chars, from one default_rng(3)."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs

    rng = np.random.default_rng(3)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S3 - 1)
    line = 3
    for c in range(32, 127):
        for s, t in enumerate(rng.permutation(S3)):
            allstr.state_lookup[(c, s)] = (line, int(t))
            line += 1
    model = h2r.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[])],
                                             max_chars_size=L3)
    return (h2r.PallasMatcher(model, max_pairs=4096),
            rng.integers(32, 127, size=(B3, L3)).astype(np.uint8))


def bound(nbytes: float, ops: float, half2: float = 0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate, the int32 operations over the int32 rate and the
    half2 instructions over theirs (the two pipes side by side)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = max(ops / INT32_OPS_PER_S, half2 / HALF2_INSTRS_PER_S) * 1e3
    out = {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
           "bytes": float(nbytes), "ops": float(ops)}
    if half2:
        out["half2_instructions"] = float(half2)
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def fb_bound(plan, en: torch.Tensor) -> dict:
    """fb_only's bound on this enable plane: it reads the plane once and,
    where a boundary word (en & ~en_next) is nonzero, that position's log
    words; the card moves a whole 32-byte sector (8 words of a row) for
    each, so the log bytes are the distinct sectors the boundary words
    touch, times the log planes.  Operations: an AND and an OR a boundary
    log word."""
    en_next = torch.cat([en[:, 1:], torch.zeros_like(en[:, :1])], 1)
    bnd = (en & ~en_next) != 0
    n_bnd = int(bnd.sum())
    n_sect = int(bnd.reshape(*bnd.shape[:-1], -1, 8).any(-1).sum())
    words = en.shape[0] * en.shape[2]
    return bound(nbytes(en) + 32 * n_sect * plan.sb_sum + words * plan.n_defs * 8 * 4,
                 2 * n_bnd * plan.sb_sum)


def host_ms(fn, iters: int = ITERS, warmup: int = 1) -> dict:
    """Median and IQR of the host time of ``iters`` calls after ``warmup``
    untimed ones (no synchronise inside a call): the time to enqueue a
    card call, or the whole time of a host function."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "iqr": [float(q1), float(q3)], "all": ms, "runs": iters}


def profile_call(fn, n: int = 5) -> dict:
    """One torch.profiler trace of ``n`` back-to-back calls: per call, the
    device busy time (the sum of the kernels' durations), the time by
    kernel, and the top-level host calls (torch ops and CUDA runtime calls
    outside any op) by their total time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern, host = {}, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + us
        elif e.cpu_parent is None:
            host[e.name] = host.get(e.name, 0.0) + us

    def top(d, k):
        return [(name[:60], v / n / 1e3) for name, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]

    return {"busy_ms": sum(kern.values()) / n / 1e3, "kernels": top(kern, 8),
            "host": top(host, 8), "n_kernels": sum(1 for e in prof.events()
                                                  if e.device_type == DeviceType.CUDA) / n}


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a is None or b is None:  # an output the mode does not write (en_pack off)
        if (a is None) != (b is None):
            raise AssertionError("an output is missing on one side")
        return 0
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max().item())


def as_dict(out) -> dict:
    """A path's output (witness/match dict or RegexResult) as a dict."""
    return out if isinstance(out, dict) else vars(out)


def assert_same(path: str, got, want, dtypes=None) -> None:
    """Two outputs (dicts or RegexResults, of tensors or of numpy arrays)
    are equal field by field, shapes and dtypes included; ``dtypes`` names
    a field's dtype in ``got`` where it is not ``want``'s."""
    got, want = as_dict(got), as_dict(want)
    if set(got) != set(want):
        raise AssertionError(f"{path}: keys {sorted(got)} vs {sorted(want)}")
    for key in want:
        a, b = got[key], want[key]
        dt = (dtypes or {}).get(key, b.dtype)
        equal = np.array_equal if isinstance(b, np.ndarray) else torch.equal
        if a.shape != b.shape or a.dtype != dt or not equal(a, b):
            raise AssertionError(f"{path}[{key}]: {a.dtype}{tuple(a.shape)} differs from "
                                 f"{dt}{tuple(b.shape)}")


def fmt(t: dict) -> str:
    return f"{t['median']:.4f} ms (IQR {t['iqr'][0]:.4f}-{t['iqr'][1]:.4f})"


def oracle_equal(path: str, out, keys, rows: dict, idx: np.ndarray) -> None:
    """The subset ``idx`` of a path's output equals the numpy oracle's
    results ``rows`` (string index -> match_substrs result) on ``keys``."""
    out = as_dict(out)
    sub = torch.from_numpy(idx).to(out[keys[0]].device)
    host = {k: out[k][sub].cpu().numpy() for k in keys}
    for r, i in enumerate(idx):
        for key in keys:
            if not np.array_equal(np.asarray(host[key][r]).astype(np.int64),
                                  np.asarray(getattr(rows[int(i)], key)).astype(np.int64)):
                raise AssertionError(f"{path}: string {i}: {key} differs from the oracle")


def knob_paths(h2r, bp, kernels, knob_ms, hdr, chars, lengths, main, twins, oracle_rows,
               idx, flush, card) -> dict:
    """[4]-[6] of the knob paths (``KNOB_PATHS``) and of ``scan_planes``
    (B7, each def of the 3-def email model ``hdr``), at B x L on the
    from: corpus: each new kernel and kernel mode against its plain
    version on the same inputs (``main``: the default plan's length table,
    pack, scan and enable planes); each path once through the matcher with
    the launch counts reset just before it, equal to its plain pipeline,
    to its column set's default-knob path ``twins`` and, on the subset
    ``idx``, to the numpy oracle; then kernel and end-to-end times.  The
    plain scans take seconds a run, so the plain versions of these
    kernels and paths are timed over fewer runs (``runs`` in the record).
    Returns the ``kernels`` rows of the four new kernels, the mode rows of
    the existing ones, and the record."""
    from halo2_regex_tpu_torch.ops.reference import match_substrs

    P = {p: m.plan for p, m in knob_ms.items()}
    p3 = hdr.plan
    words = B // 32
    plane = L * words * 4  # bytes of one [NWS, L, 128] int32 plane

    def ops(plan, what, defs=None):
        cs = plan.circuits if defs is None else [plan.circuits[d] for d in defs]
        f = {"class": lambda c: c.class_prog.n_ops if plan.class_stage else 0,
             "step": lambda c: c.step_ops, "tag": lambda c: c.tag_ops}[what]
        return sum(f(c) for c in cs) * L * words

    def n_in(plan, d):  # the scan input planes def d reads
        return len(plan.circuits[d].class_plane_names) or 8

    len_wb, bits_p, en_p, logs_p = (main[k] for k in ("len_wb", "bits", "en", "logs"))
    quads = bp.raw_quads(chars, L)
    pk = P["witness_kdecode"]
    g4_p = bp.post_plain(pk, logs_p, en_p)[0].contiguous()
    ch_l4 = chars.reshape(-1).view(torch.int32).reshape(B, pk.l4)
    bits3 = kernels.qpack_cuda(p3, chars, bp.len_table(lengths))[0]
    inputs = {}  # a mode's scan input: its pack's plain output
    for mode, path in (("class_off", "witness_class_off"), ("onehot", "witness_onehot")):
        inputs[mode] = bp.qpack_plain(P[path], chars, len_wb)
    # (kernel, mode or None, the path that launches it, kernel call, plain
    # call, bound, plain runs)
    stages = []
    for mode, path in (("class_off", "witness_class_off"), ("onehot", "witness_onehot"),
                       ("en_off", "match_en_off")):
        pl = P[path]
        stages.append((kernels.QPACK, mode, path,
                       lambda pl=pl: kernels.qpack_cuda(pl, chars, len_wb),
                       lambda pl=pl: bp.qpack_plain(pl, chars, len_wb),
                       bound(B * L + nbytes(len_wb) * pl.en_pack + plane * (pl.kp + pl.en_pack),
                             ops(pl, "class")), (PLAIN_WARMUP, PLAIN_ITERS)))
    scan_modes = [("fold_class", "witness_class_off", inputs["class_off"][0]),
                  ("onehot", "witness_onehot", inputs["onehot"][0])]
    scan_modes += [(f"unroll{u}", f"witness_unroll{u}", bits_p) for u in (1, 2, 4, 8)]
    for mode, path, x in scan_modes:
        pl = P[path]
        stages.append((kernels.SCAN, mode, path, lambda pl=pl, x=x: kernels.scan_cuda(pl, x),
                       lambda pl=pl, x=x: bp.scan_plain(pl, x),
                       bound(plane * (pl.kp + pl.sb_sum), ops(pl, "step")), (0, 1)))
    pf = P["witness_fuse_pack"]
    # the in-scan pack: 8 byte-bit planes of 8 shift-and-or terms a word
    stages.append((kernels.SCAN_FPACK, None, "witness_fuse_pack",
                   lambda: kernels.scan_fpack_cuda(pf, quads), lambda: bp.scan_fpack_plain(pf, quads),
                   bound(nbytes(quads) + plane * pf.sb_sum,
                         ops(pf, "step") + 8 * 8 * 3 * L * words), (0, 1)))
    # scan_planes: one launch per def, the row times the three together
    stages.append((kernels.SCAN_DEF, None, "scan_planes",
                   lambda: [kernels.scan_def_cuda(p3, bits3, d) for d in range(p3.n_defs)],
                   lambda: [bp.scan_def_plain(p3, bits3, d) for d in range(p3.n_defs)],
                   bound(sum(plane * (n_in(p3, d) + c.sb) for d, c in enumerate(p3.circuits)),
                         ops(p3, "step")), (0, 1)))
    pd = P["witness_direct"]
    stages.append((kernels.POST_DIRECT, None, "witness_direct",
                   lambda: kernels.post_direct_cuda(pd, logs_p, en_p),
                   lambda: bp.post_direct_plain(pd, logs_p, en_p),
                   bound(plane * (pd.sb_sum + 1) + len(pd.dfields) * B * L, ops(pd, "tag")),
                   (PLAIN_WARMUP, PLAIN_ITERS)))
    stages.append((kernels.POST, "kdecode", "witness_kdecode",
                   lambda: kernels.post_cuda(pk, logs_p, en_p), lambda: bp.post_plain(pk, logs_p, en_p),
                   bound(plane * (pk.sb_sum + 1 + 8 * pk.n_groups) + words * pk.n_defs * 8 * 4,
                         ops(pk, "tag")), (PLAIN_WARMUP, PLAIN_ITERS)))
    # the decode: per output int32 four byte extractions and placements
    n_out = len(pk.fields_flat) + 1
    stages.append((kernels.DECODE, None, "witness_kdecode",
                   lambda: kernels.decode_cuda(pk, g4_p, ch_l4), lambda: bp.decode_plain(pk, g4_p, ch_l4),
                   bound(nbytes(g4_p, ch_l4) + n_out * B * L, 16 * n_out * B * L // 4),
                   (PLAIN_WARMUP, PLAIN_ITERS)))
    pp = P["witness_planes"]
    stages.append((kernels.POST_PLANES, "witness", "witness_planes",
                   lambda: kernels.post_planes_cuda(pp, logs_p, en_p),
                   lambda: bp.post_planes_plain(pp, logs_p, en_p),
                   bound(plane * (pp.sb_sum + 1 + pp.p_total), ops(pp, "tag")),
                   (PLAIN_WARMUP, PLAIN_ITERS)))

    def label(k, mode):
        return k.name if mode is None else f"{k.name}[{mode}]"

    errs = {}
    for k, mode, _path, run_k, run_p, bd, _runs in stages:
        want = run_p()
        got = run_k()
        torch.cuda.synchronize()
        errs[label(k, mode)] = err = max_abs_err(got, want)
        log(f"[4] {label(k, mode)}: kernel vs plain max_abs_err={err} (tolerance 0, integer "
            f"outputs); bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        if err != 0:
            raise AssertionError(f"{label(k, mode)} kernel disagrees with its plain version")
        if k is kernels.SCAN_DEF:  # each def's planes are the fused scan's slice
            fused = kernels.scan_cuda(p3, bits3)
            for d, c in enumerate(p3.circuits):
                if not torch.equal(got[d], fused[:, p3.sb_off[d]: p3.sb_off[d] + c.sb]):
                    raise AssertionError(f"scan_def of def {d} differs from the fused scan's slice")
            log(f"[4] scan_def: each of the {p3.n_defs} defs equals its slice of the fused scan")
            del fused
        del got, want

    # [5] each path once, with launch counts
    launches, outs, n_ok = {}, {}, {}
    for path, m in knob_ms.items():
        columns = KNOB_PATHS[path][0]
        kernels.reset_launch_counts()
        out = m(chars, lengths)
        torch.cuda.synchronize()
        launches[path] = counts(kernels)
        want = {k.name: 0 for k in kernels.KERNELS}
        want.update({k.name: n for k, n in kernels.path_launches(m.plan).items()})
        log(f"[5] {path}: launches {launches[path]}")
        if launches[path] != want:
            raise AssertionError(f"{path}: launch counts {launches[path]}, expected {want}")
        assert_same(path, out, bp.run(m.plan, m.tables(), chars, lengths, plain=True))
        assert_same(f"{path} vs {columns}", out, twins[columns])
        oracle_equal(path, out, ORACLE_KEYS.get(columns) or h2r.RegexResult.field_names(),
                     oracle_rows, idx)
        torch.cuda.synchronize()
        n_ok[path] = int(as_dict(out)["match_ok"].sum())
        log(f"[5] {path}: equals its plain pipeline and the default-knob {columns} path on all "
            f"{len(as_dict(out))} outputs, dtypes included; {len(idx)} strings equal the "
            f"numpy oracle")
        del out
    kernels.reset_launch_counts()
    got = [hdr.scan_planes(bits3, d) for d in range(p3.n_defs)]
    torch.cuda.synchronize()
    launches["scan_planes"] = counts(kernels)
    log(f"[5] scan_planes: launches {launches['scan_planes']}")
    if launches["scan_planes"] != {k.name: p3.n_defs * (k is kernels.SCAN_DEF)
                                   for k in kernels.KERNELS}:
        raise AssertionError("scan_planes: expected one scan_def launch per def and no other")
    assert_same("scan_planes", dict(enumerate(got)),
                dict(enumerate(bp.scan_def_plain(p3, bits3, d) for d in range(p3.n_defs))))
    # the states after each byte, unpacked, against the oracle's
    vals = bp.unpack_groups([(f"s{d}", [got[d][:, j] for j in range(c.sb)])
                             for d, c in enumerate(p3.circuits)], L)
    c_np, l_np = (t.cpu().numpy() for t in (chars, lengths))
    host = {d: vals[f"s{d}"][torch.from_numpy(idx).to(chars.device)].cpu().numpy()
            for d in range(p3.n_defs)}
    for r, i in enumerate(idx):
        o = match_substrs(hdr.model.regex_defs, bytes(c_np[i, : l_np[i]]), L)
        for d in range(p3.n_defs):
            n = int(l_np[i])
            if not np.array_equal(host[d][r, :n].astype(np.int64),
                                  np.asarray(o.states[d, 1: n + 1]).astype(np.int64)):
                raise AssertionError(f"scan_planes: string {i}, def {d}: states differ from "
                                     "the oracle")
    log(f"[5] scan_planes: equals scan_def_plain for each def; {len(idx)} strings' states "
        f"equal the numpy oracle's for all {p3.n_defs} defs")
    del got, vals

    # [6] timings
    rows, modes, times = [], {}, {}
    for k, mode, path, run_k, run_p, bd, (pw, pi) in stages:
        tk = time_ms(run_k, flush, device_only=True)
        tp = time_ms(run_p, flush, device_only=True, warmup=pw, iters=pi)
        times[label(k, mode)] = {"kernel": tk, "plain": tp, **bd}
        log(f"[6] {label(k, mode)}: kernel {fmt(tk)}, plain {fmt(tp)} over {tp['runs']} runs; "
            f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        row = {"launches": launches[path][k.name], "max_abs_err": errs[label(k, mode)],
               "ms": tk["median"], "plain_ms": tp["median"], "bound_ms": bd["bound_ms"],
               "bound_by": bd["bound_by"], "library_ms": None}
        if mode is None:
            rows.append({"name": k.name, "route": "cuda", "source": k.source,
                         "replaces": k.replaces, **row})
        else:
            modes.setdefault(k.name, {})[mode] = row
    for path, m in knob_ms.items():
        t = time_ms(lambda: m(chars, lengths), flush, device_only=False)
        tp = time_ms(lambda: bp.run(m.plan, m.tables(), chars, lengths, plain=True), flush,
                     device_only=False, warmup=0, iters=1)
        times[f"end_to_end_{path}"] = {"kernel": t, "plain": tp,
                                       "input_gb_per_s": B * L / (t["median"] * 1e-3) / 1e9}
        log(f"[6] end to end {path}: {fmt(t)}, "
            f"{times[f'end_to_end_{path}']['input_gb_per_s']:.3f} GB/s of input; plain "
            f"pipeline {fmt(tp)} over 1 run; card {card}")
    t = time_ms(lambda: [hdr.scan_planes(bits3, d) for d in range(p3.n_defs)], flush,
                device_only=False)
    times["end_to_end_scan_planes"] = {"kernel": t}
    log(f"[6] end to end scan_planes ({p3.n_defs} calls): {fmt(t)}; card {card}")
    return {"rows": rows, "modes": modes, "times": times, "errs": errs, "launches": launches,
            "match_ok": n_ok}


def beyond_staging(h2r, n: int = B, length: int = 64):
    """The two models past the table kernels' staging limits, each with its
    matcher and a seeded corpus of ``n`` strings of ``length`` bytes on the
    card: ``wide_pairs``, a random 300-state table over bytes 97..122
    whose every transition is a substring transition (one def of 7511
    pairs; over 256 states, so split), and ``nine_defs``, nine dictionary
    defs (``zoo.dictionary_config`` at seeds 1..9, monolithic)."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs, SubstrRegexDef

    S = 300
    rng = np.random.default_rng(5)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line, trans = 3, set()
    for c in range(97, 123):
        for s in range(S):
            nxt = int(rng.integers(0, S))
            allstr.state_lookup[(c, s)] = (line, nxt)
            line += 1
            trans.add((s, nxt))
    sub = SubstrRegexDef(max_length=length, min_position=0, max_position=length,
                         valid_state_transitions=trans, start_states=list(range(0, S, 7)),
                         end_states=list(range(3, S, 5)))
    wide = h2r.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[sub])],
                                            max_chars_size=length)
    cfgs = [h2r.DecomposedRegexConfig.from_json(h2r.zoo.dictionary_config(40, seed=s,
                                                                        max_byte_size=length))
            for s in range(1, 10)]
    nine = h2r.CompiledRegexModel.from_decomposed(cfgs, max_chars_size=length)
    wide_ch = torch.from_numpy(rng.integers(97, 123, size=(n, length)).astype(np.uint8))
    wide_ln = torch.from_numpy(rng.integers(0, length + 1, size=n).astype(np.int32))
    words = [w.encode() for cfg_ in range(1, 10) for w in
             h2r.zoo.dictionary_config(40, seed=cfg_)["parts"][1]["regex_def"][1:-1].split("|")]
    nine_ch, nine_ln = (torch.from_numpy(a) for a in dict_corpus(n, length, words, seed=6))
    dev = torch.device("cuda")
    return [("wide_pairs", h2r.PallasMatcher(wide, max_pairs=8192), wide_ch.to(dev),
             wide_ln.to(dev)),
            ("nine_defs", h2r.PallasMatcher(nine), nine_ch.to(dev), nine_ln.to(dev))]


def counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels.KERNELS}


def expect(kernels, *parts) -> dict:
    """Launch counts a path should show: zero for every kernel, plus the
    sum of ``parts`` (dicts of kernel -> launches)."""
    want = {k.name: 0 for k in kernels.KERNELS}
    for part in parts:
        for k, n in part.items():
            want[k.name] += n
    return want


# expand_witness returns the sums over defs as numpy sums them (int64),
# as the JAX package's does; every other column keeps its int32 / bool
EXPAND_DTYPES = {k: np.dtype(np.int64) for k in ("is_start_sum", "is_end_sum", "substr_id_sum")}


def prover_phase(h2r, kernels, native, model, wm, fm, chars, lengths, c_np, l_np, card) -> dict:
    """[8] The prover's flow on the from: model at B x L (bench.py:175's
    witness, then the host layer): ``BitplaneMatcher(columns="witness")``
    on the card (qpack, scan, post), ``expand_witness`` and
    ``check_witness_batch`` on the host, both timed (median and IQR of 3);
    the same verdicts from the C++ oracle's columns of the whole batch
    (``native.native_result``) and from the card's ``columns="full"``
    result (``compact=False``: JAX's int32 columns; the checker's gates
    read the compact result's uint8 enable column as wrapping); ``save_witness`` / ``load_witness`` on a slice of rows; the
    hand-off dump of one matching row of the card's result (its tensors
    passed as they are), ``verify_handoff`` and the C++ ``handoff_check``
    on it.  Every output is held bit for bit, dtypes included."""
    from halo2_regex_tpu_torch.witness import handoff

    rec, launches = {}, {}
    kernels.reset_launch_counts()
    w = wm(chars, lengths)
    torch.cuda.synchronize()
    launches["prover_witness"] = got = counts(kernels)
    if got != expect(kernels, kernels.path_launches(wm.plan)):
        raise AssertionError(f"prover witness: launches {got}")
    log(f"[8] prover: BitplaneMatcher(columns='witness') on the card, launches {got}")
    # the card's witness dict and raw bytes go to the host layer unchanged
    last = {}  # the runs are the work: no warm-up
    t_exp = host_ms(lambda: last.update(full=h2r.expand_witness(model, w, chars)), 3, warmup=0)
    full = last["full"]
    t_chk = host_ms(lambda: last.update(ok=h2r.check_witness_batch(model.regex_defs, full)), 3,
                    warmup=0)
    ok = last["ok"]
    t0 = time.perf_counter()
    nat = native.native_result(model, c_np, l_np)
    t_nat = time.perf_counter() - t0
    ok_nat = h2r.check_witness_batch(model.regex_defs, nat)
    assert_same("prover: expand_witness vs the native oracle", full, nat, EXPAND_DTYPES)
    kernels.reset_launch_counts()
    res = fm(chars, lengths)
    torch.cuda.synchronize()
    launches["prover_full"] = got = counts(kernels)
    if got != expect(kernels, kernels.path_launches(fm.plan)):
        raise AssertionError(f"prover full: launches {got}")
    res_np = res.to_numpy()
    assert_same("prover: the card's full result vs the native oracle", res_np, nat)
    ok_full = h2r.check_witness_batch(model.regex_defs, res_np)
    for what, v in (("the native oracle's columns", ok_nat), ("the full result", ok_full),
                    ("match_ok", nat.match_ok)):
        if v.dtype != ok.dtype or not np.array_equal(v, ok):
            raise AssertionError(f"prover: the checker's verdicts differ on {what}")
    n_ok = int(ok.sum())
    if not 0 < n_ok:
        raise AssertionError("prover: no witness verifies")
    rec.update(expand_ms=t_exp, check_ms=t_chk, native_s=t_nat, verified=n_ok,
               rejected=int(ok.size - n_ok))
    log(f"[8] prover: expand_witness {fmt(t_exp)}, check_witness_batch {fmt(t_chk)} on the "
        f"host for B={ok.size} x L={c_np.shape[1]} (3 runs each); verdicts {n_ok} verified, "
        f"{ok.size - n_ok} rejected, equal to the checker's on the native oracle's columns "
        f"({t_nat:.3f} s), on the card's full result and to match_ok; the expanded columns "
        f"equal the oracle's; card {card}")
    # the npz artifact on a slice of rows
    work = kernels.build_root() / "prover"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "witness.npz"
    part = res.map(lambda a: a[:ORACLE_N])  # card tensors
    t0 = time.perf_counter()
    h2r.save_witness(path, model.regex_defs, part)
    defs, back, _tables = h2r.load_witness(path)
    rec["npz"] = {"rows": ORACLE_N, "bytes": path.stat().st_size,
                  "seconds": time.perf_counter() - t0}
    assert_same("prover: load_witness(save_witness)", back, part.to_numpy())
    if [d.allstr.to_text() for d in defs] != [d.allstr.to_text() for d in model.regex_defs]:
        raise AssertionError("prover: the npz's defs differ")
    # the hand-off of one matching row of the card's result
    i = int(np.flatnonzero(ok)[0])
    meta = {"model": "from", "row": str(i), "max_chars_size": str(c_np.shape[1])}
    text = handoff.dump_prover_rows(model.regex_defs, res.map(lambda a: a[i]), meta=meta)
    if text != handoff.dump_prover_rows(model.regex_defs, nat.map(lambda a: a[i]), meta=meta):
        raise AssertionError("prover: the hand-off dump differs from the native oracle's")
    errs = handoff.verify_handoff(handoff.load_prover_rows(text))
    dump = work / "handoff.txt"
    dump.write_text(text)
    r = native.handoff_check(dump)
    lines = text.splitlines()
    k = lines.index("[advice states def=0]") + 4
    lines[k] = str(int(lines[k]) + 1)
    dump.write_text("\n".join(lines) + "\n")
    r_bad = native.handoff_check(dump)
    if errs or r.returncode != 0 or "clean" not in r.stdout or r_bad.returncode != 1:
        raise AssertionError(f"prover: hand-off of row {i}: {errs[:3]}, handoff_check "
                             f"{r.returncode} {r.stdout!r}, tampered {r_bad.returncode}")
    for f in (path, dump):
        f.unlink()
    work.rmdir()
    rec["handoff_lines"] = len(lines)
    log(f"[8] prover: save/load_witness of {ORACLE_N} card rows round-trips "
        f"({rec['npz']['bytes']} B); the hand-off dump of row {i} ({len(lines)} lines) equals "
        f"the oracle row's, verify_handoff clean, handoff_check clean and rejects a tampered "
        f"state")
    return {"rec": rec, "launches": launches}


def scan_launches(kernels, n_defs: int, rows: int, Ls: int, dev) -> int:
    """The table scan's launches for one call over ``rows`` strings of
    ``Ls`` bytes: two in its chunked form, one in its serial form."""
    return 2 if kernels.table_scan_form(n_defs, rows, Ls, dev)[0] else 1


def parallel_phase(h2r, kernels, model, model3, xla, mf, m3, mp, chars, lengths,
                   chars3, lengths3, chars_p, lengths_p, corpus_file, model_file, cli_counts,
                   flush, card, dev) -> dict:
    """[9] The sharded matchers on the one card, each driven once with the
    launch counts reset and held bit for bit (dtypes included) to the
    unsharded card matcher on the same inputs, then timed in turns with
    it: ``DistributedMatcher`` (xla and pallas) at B x L on the from:
    corpus over a 4 x 1 mesh of the card (``[cuda:0] * 4``: one process,
    the shards one after another), ``SeqShardedMatcher`` there over 1 x 4,
    ``SpeculativeSeqMatcher(per_shard="pallas")`` on configs[3] and on the
    permutation DFA over 1 x 4 (its rounds printed), and
    ``parallel.launch`` at world size 1 over nccl on cli_scan's file, in
    turns with ``ScanJob`` on the portable scan."""
    from halo2_regex_tpu_torch.parallel import seq_parallel as sp

    rec, launches, times = {}, {}, {}
    mesh_d = h2r.make_mesh(data=4, devices=[dev] * 4)
    mesh_s = h2r.make_mesh(data=1, seq=4, devices=[dev] * 4)
    dm_x = h2r.DistributedMatcher(model, mesh_d)
    dm_p = h2r.DistributedMatcher(model, mesh_d, backend="pallas")
    seq = h2r.SeqShardedMatcher(model, mesh_s)
    spec3 = sp.SpeculativeSeqMatcher(model3, mesh_s, per_shard="pallas")
    spec_p = sp.SpeculativeSeqMatcher(mp.model, mesh_s, per_shard="pallas")
    Bs, Ls, Ls3 = B // 4, L // 4, L3 // 4
    S = model.s_pad
    group = max(1, min(B, sp.PASS1_BYTES // (model.n_defs * Ls * S * 4)))
    pass1 = sum(scan_launches(kernels, model.n_defs, min(group, B - b0) * S, Ls, dev)
                for b0 in range(0, B, group))
    ts = kernels.TABLE_SCAN
    expected = {
        "dp_xla": {ts: 4 * scan_launches(kernels, model.n_defs, Bs, L, dev)},
        "dp_pallas": {k: 4 * n for k, n in
                      kernels.table_path_launches(dm_p.pallas[mesh_d.device(0)], Bs).items()},
        "seq": {ts: 4 * (pass1 + scan_launches(kernels, model.n_defs, B, Ls, dev))},
    }
    refs = {"dp_xla": (xla, chars, lengths), "dp_pallas": (mf, chars, lengths),
            "seq": (xla, chars, lengths), "spec_configs3": (m3, chars3, lengths3),
            "spec_permutation": (mp, chars_p, lengths_p)}
    runs = {"dp_xla": (dm_x, model, chars, lengths), "dp_pallas": (dm_p, model, chars, lengths),
            "seq": (seq, model, chars, lengths), "spec_configs3": (spec3, model3, chars3, lengths3),
            "spec_permutation": (spec_p, mp.model, chars_p, lengths_p)}
    for path, (m, mdl, ch, ln) in runs.items():
        kernels.reset_launch_counts()
        out = m(ch, ln)
        torch.cuda.synchronize()
        launches[path] = got = counts(kernels)
        ref_m, rch, rln = refs[path]
        ref = ref_m(rch, rln)
        if path.startswith("dp"):
            res, stats = out
            want = {"n_matched": ref.match_ok.sum(), "n_failed": (~ref.match_ok).sum(),
                    "n_dead": ref.has_dead.any(1).sum(), "bytes_scanned": rln.sum(),
                    "extracted_bytes": (ref.mask * ref.all_enable_flags).sum()}
            for k, v in want.items():
                if stats[k].dtype != np.int32 or int(stats[k]) != int(v):
                    raise AssertionError(f"{path}: stats[{k}] {stats[k]!r}, expected {int(v)}")
            rec[f"{path}_stats"] = {k: int(v) for k, v in stats.items()}
        else:
            out = dict(out)
            rounds = out.pop("spec_rounds", None)
            res = sp._assemble_result(mdl, out, ch, ln)
            if rounds is not None:
                rounds = int(rounds[0])
                rec[f"{path}_rounds"] = rounds
                expected[path] = {ts: rounds * 4 * scan_launches(kernels, 1, B3, Ls3, dev)}
        if got != expect(kernels, expected[path]):
            raise AssertionError(f"{path}: launches {got}, expected {expected[path]}")
        assert_same(f"{path} vs the unsharded matcher", res, ref)
        torch.cuda.synchronize()
        log(f"[9] {path}: launches {got}; equals {type(ref_m).__name__} on the same inputs on "
            f"every field, dtypes included"
            + (f"; spec_rounds {rounds}" if path.startswith("spec") else "")
            + (f"; stats {rec[f'{path}_stats']}" if path.startswith("dp") else ""))
        del out, res, ref
    if rec["spec_permutation_rounds"] != 4:
        raise AssertionError("spec_permutation: every guess is wrong, so it needs 4 rounds")
    # walls in turns: unsharded, sharded, sharded, unsharded
    for path, (m, mdl, ch, ln) in runs.items():
        ref_m, rch, rln = refs[path]
        order = [("unsharded", lambda: ref_m(rch, rln)), ("sharded", lambda: m(ch, ln))]
        seqs = {}
        for name, fn in order + order[::-1]:
            seqs.setdefault(name, []).append(time_ms(fn, flush, device_only=False))
        # where the sharded wall goes: the kernels' busy time in a trace
        prof = profile_call(lambda: m(ch, ln), n=3)
        seqs["profile"] = prof
        times[path] = seqs
        wall = float(np.median([t["median"] for t in seqs["sharded"]]))
        log(f"[9] {path} wall: sharded {', '.join(fmt(t) for t in seqs['sharded'])}; "
            f"unsharded {type(ref_m).__name__} {', '.join(fmt(t) for t in seqs['unsharded'])} "
            f"(in turns); card {card}")
        log(f"[9] {path} profile (3 calls): device busy {prof['busy_ms']:.4f} ms a call, "
            f"{100 * prof['busy_ms'] / wall:.1f} % of the sharded wall's median, "
            f"{prof['n_kernels']:.0f} kernels a call; kernels (ms a call): "
            + "; ".join(f"{n} {v:.4f}" for n, v in prof["kernels"])
            + "; host (ms a call): " + "; ".join(f"{n} {v:.4f}" for n, v in prof["host"]))
    # launch at world size 1 (nccl), in turns with ScanJob on the portable
    # scan: on cli_scan's file, and on that file LAUNCH_REPEAT times over,
    # where the launcher's start-up inside its timed window (its first
    # calls and first collective, in a fresh process) is a small share;
    # the two files' walls give its rate past that start-up
    import socket

    def run(what, path):
        if what == "scan_job":
            c = json.loads(h2r.ScanJob(xla, [str(path)], batch_size=B,
                                       keep_newline=True).run().to_json())
            return {"n_matched": c["matched"], "strings": c["strings"],
                    "bytes_scanned": c["bytes_scanned"], "n_dead": c["dead"],
                    "bytes_per_sec": c["bytes_per_sec"], "wall_seconds": c["wall_seconds"]}
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        r = subprocess.run(
            [sys.executable, "-m", "halo2_regex_tpu_torch.parallel.launch", "--model",
             str(model_file), "--corpus", str(path), "--batch-per-host", str(B),
             "--keep-newline", "--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "1", "--process-id", "0"],
            env=env, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"launch exited {r.returncode}: {r.stderr[-2000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    big = corpus_file.with_name("corpus_repeated.txt")
    data = corpus_file.read_bytes()
    with open(big, "wb") as f:
        for _ in range(LAUNCH_REPEAT):
            f.write(data)
    lruns = {}
    for size, path, reps, turns in (
            ("small", corpus_file, 1, ("scan_job", "launch")),
            ("repeated", big, LAUNCH_REPEAT, ("scan_job", "launch", "launch", "scan_job"))):
        want = {"n_matched": cli_counts["matched"], "strings": cli_counts["strings"],
                "bytes_scanned": cli_counts["bytes_scanned"], "n_dead": cli_counts["dead"]}
        want = {k: reps * v for k, v in want.items()}
        for what in turns:
            got = run(what, path)
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"{what} on the {size} file: totals {got}, {reps} x "
                                     f"cli_scan's {want}")
            lruns.setdefault(size, {}).setdefault(what, []).append(got)
    big.unlink()
    small_l, big_l = lruns["small"]["launch"][0], lruns["repeated"]["launch"]
    wall_big = float(np.mean([r["wall_seconds"] for r in big_l]))
    rate = ((big_l[0]["bytes_scanned"] - small_l["bytes_scanned"])
            / (wall_big - small_l["wall_seconds"]))
    startup = small_l["wall_seconds"] - small_l["bytes_scanned"] / rate
    rec["launch"] = dict(lruns, repeat=LAUNCH_REPEAT, past_startup_bytes_per_sec=rate,
                         startup_seconds=startup)
    log(f"[9] launch (world size 1, nccl) counts what cli_scan counts, on its file "
        f"({cli_counts['matched']} of {cli_counts['strings']}) and on it {LAUNCH_REPEAT} times "
        f"over ({big_l[0]['bytes_scanned']} bytes); bytes_per_sec on the file "
        f"{small_l['bytes_per_sec']} against ScanJob(BatchMatcher)'s "
        f"{lruns['small']['scan_job'][0]['bytes_per_sec']}; on the repeated file "
        f"{[r['bytes_per_sec'] for r in big_l]} against "
        f"{[r['bytes_per_sec'] for r in lruns['repeated']['scan_job']]} (turns: job, launch, "
        f"launch, job; file reads, packing and copies included); from the two files' walls, "
        f"launch's rate past its start-up {rate:.1f} B/s and its start-up "
        f"{startup:.3f} s; card {card}")
    return {"rec": rec, "launches": launches, "times": times}


def probe_lines(kernels, recs, group, got: dict, label, tag: str, card: str):
    """The kernel lines of a probe phase: each record of a kernel in
    ``group`` held to this card, one launch a measured call and
    ``max_abs_err`` 0; its bound (bytes, int32 ops and, for a tensor-core
    line, its mma flops over the dense peak), a log line, and the
    per-width entry.  Returns (rows: the first width's entry a kernel,
    with the phase's launches ``got`` and every width under ``configs``;
    times; errs)."""
    from halo2_regex_tpu_torch.probes import harness

    rows, tms, errs, configs = {}, {}, {}, {}
    for r in recs:
        name, lab = r["kernel"], label(r)
        errs[f"{name}[{lab}]"] = r["max_abs_err"]
        if (r["device"] != "cuda" or r["card"] != card or r["launches"] != r.get("calls", 1)
                or (r["max_abs_err"] and not r.get("within_tolerance"))):
            raise AssertionError(f"{tag} {name} [{lab}]: {r}")
        bd = bound(r["nbytes"], r["int32_ops"], r.get("half2_ops", 0))
        if r.get("mma_flops"):
            t_m = r["mma_flops"] / r["mma_peak"] * 1e3
            if t_m > bd["bound_ms"]:
                bd.update(bound_ms=t_m, bound_by="operations")
            bd["mma_flops"] = float(r["mma_flops"])
        lib = r["library_ms"]
        tms[f"{name}[{lab}]"] = {"kernel": {"median": r["ms"], "iqr": r["iqr"]},
                                 "plain_ms": r["plain_ms"], "library_ms": lib, **bd,
                                 "ns_per_step": r["ns_per_step"],
                                 "cycles_per_step": r["cycles_per_step"]}
        tol = ("within the elementwise tolerance" if "within_tolerance" in r
               else "tolerance 0")
        log(f"{tag} {name} [{lab}]: kernel vs plain max_abs_err={r['max_abs_err']} ({tol}); "
            f"kernel {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-{r['iqr'][1]:.4f}), "
            f"{r['ns_per_step']:.3f} ns = {r['cycles_per_step']:.1f} cycles a step at "
            f"{harness.CLOCK_HZ / 1e9:.2f} GHz over {r['steps']} steps; plain "
            f"{r['plain_ms']:.4f} ms (1 run)" + (f"; library {lib:.4f} ms" if lib is not None else "")
            + f"; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; {r['launches']} launch(es) "
            f"a call (counted); card {card}")
        entry = {"launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": bd["bound_ms"],
                 "bound_by": bd["bound_by"], "library_ms": lib, "ns_per_step": r["ns_per_step"]}
        configs.setdefault(name, {})[lab] = entry
        if name not in rows:  # the first width is the row's
            k = next(k for k in group if k.name == name)
            rows[name] = {"name": name, "route": "cuda", "source": k.source,
                          "replaces": k.replaces, **entry, "launches": got[name],
                          "configs": configs[name]}
    return rows, tms, errs


def probe_phase(kernels, plan, times: dict, chain3, segment: int, card: str) -> dict:
    """[10] The serial-scan probes of tools/ (``probes/``): each probe
    script's ``run`` at [10]'s widths, the launch counts reset just before
    and read just after.  Each of their lines holds a kernel against its
    plain version (``harness.measure``: one call with every kernel's count
    read around it, 2 + 10 timed runs with the L2 flushed, the last output
    against the plain version's, which runs once; ``torch.cumsum`` beside
    loop_floor; loop_floor and slab_scan in their default, chunked form at
    every width and in their serial form too at [65536, 64]; bitop_scan's
    table build, then its table and serial forms at every n_ops on one plain
    output; chains' fixed and serial forms in both geometries, the fixed
    form's steps counter equal to its twin's); then the two serial scans are
    set on the measured curves: K2's step-circuit ops a position and cycles
    a position against bitop_scan's serial sweep, configs[3]'s table-scan
    chain step against the serial forms of loop_floor and slab_scan at
    [65536, 64].  ptxas' log and the SASS show no spills and no local
    memory (LDL, STL) in the chunked kernels, bitop_scan's table kernels
    and chains' fixed form."""
    from halo2_regex_tpu_torch.probes import harness, probe_tpu9, probe_tpu20, probe_tpu56

    dev = torch.device("cuda")
    clock = harness.CLOCK_HZ
    kernels.reset_launch_counts()
    recs = (probe_tpu9.run(dev, FLOOR_WIDTHS, SLAB_WIDTHS, ((L3, B3),))
            + probe_tpu20.run(dev, BITOP_L, BITOP_NWS)
            + probe_tpu56.run(dev))
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in kernels.KERNELS + kernels.PROBE_KERNELS}
    if (any(got[k.name] for k in kernels.KERNELS + kernels.TABLE_PROBES + kernels.EMIT_PROBES)
            or not all(got[k.name] for k in kernels.SERIAL_PROBES)):
        raise AssertionError(f"[10] the probe scripts' launches {got}")
    log(f"[10] probe scripts (probe_tpu9.run, probe_tpu20.run, probe_tpu56.run), launches "
        f"{dict((k, v) for k, v in got.items() if v)}")

    def label(r) -> str:
        at = "x".join(map(str, r["shape"]))
        return {"A_loop_floor": f"slab 1, {at}, {r.get('form')}",
                "B_slab8_floor": f"slab 8, {at}, {r.get('form')}",
                "C_slab8_scan": f"{at}, {r.get('form')}",
                "A_bitop_table": f"n_ops {r.get('n_ops')}",
                "A_bitop_scan": f"n_ops {r.get('n_ops')}, {r.get('form')}",
                "A_chains": f"C {r.get('C')}, {r.get('threads')} threads a block, "
                            f"{r.get('form')}"}[r["probe"]]

    for r in recs:
        if r["probe"] == "A_bitop_scan" and not r["nonzero_share"] > 0:
            raise AssertionError(f"[10] bitop_scan [{label(r)}]: the timed output is all zero")
        if r["probe"] == "A_chains" and r["form"] == "fixed":
            if r["steps_run"] != r["steps_plain"]:
                raise AssertionError(f"[10] chains [{label(r)}]: the kernel ran "
                                     f"{r['steps_run']} steps, its twin {r['steps_plain']}")
            log(f"[10] chains [{label(r)}]: the most steps a warp ran {r['steps_run']} of "
                f"{r['steps']} (the twin's {r['steps_plain']}); card {card}")
    rows, tms, errs = probe_lines(kernels, recs, kernels.SERIAL_PROBES, got, label, "[10]", card)

    # the bitplane scan (K2) on the bitop_scan curve
    k2_ops = sum(c.step_prog.n_ops for c in plan.circuits)
    k2_ms = times["scan"]["kernel"]["median"]
    k2_cyc = k2_ms * 1e-3 * clock / plan.L_pad
    sweep = [(n, tms[f"bitop_scan[n_ops {n}, serial]"]["cycles_per_step"])
             for n in probe_tpu20.N_OPS]
    slope, icpt = np.polyfit([n for n, _ in sweep], [c for _, c in sweep], 1)
    near = min(sweep, key=lambda nc: abs(nc[0] - k2_ops))
    log(f"[10] K2 (the from: witness plan's scan) has {k2_ops} step-circuit ops a position "
        f"(its circuits' step programs) and took {k2_ms:.4f} ms = {k2_cyc:.1f} cycles a "
        f"position in [6] of this run (its circuit-only variant: {K2_CIRCUIT_ONLY_CYCLES} "
        f"cycles, kernel_ab.py, PERF.md §6); bitop_scan's serial form at the nearest n_ops "
        f"{near[0]}: "
        f"{near[1]:.1f} cycles a step; the sweep {', '.join(f'{n}: {c:.1f}' for n, c in sweep)} "
        f"fits {slope:.3f} cycles an op + {icpt:.1f}, {slope * k2_ops + icpt:.1f} at {k2_ops} "
        f"ops; card {card}")
    # configs[3]'s table-scan chain beside the loop step and the probe's table step
    C3, W3 = chain3
    n3 = W3 + C3 if C3 else L3
    t3 = times["table_scan@pallas_large"]["kernel"]["median"]
    t1 = times["table_scan_one_string@pallas_large"]["kernel"]["median"]
    at = f"{L3}x{B3}"
    serial = {"loop_floor": (f"slab 1, {at}, serial", f"slab 8, {at}, serial"),
              "slab_scan": (f"{at}, serial",)}
    probe_ns = {f"{k}[{lab}]": tms[f"{k}[{lab}]"]["ns_per_step"]
                for k, labs in serial.items() for lab in labs}
    serial_launches = {f"{r['kernel']}[{label(r)}]": r["launches"] for r in recs
                       if r.get("form") == "serial"}
    log(f"[10] configs[3]'s table scan: {t3 * 1e6 / n3:.3f} ns a chain step ({t3:.4f} ms over "
        f"its {n3}-step chain, C={C3}, W={W3}); one string in the serial form "
        f"{t1 * 1e6 / segment:.3f} ns a step ({segment} steps); at {at}, ns a step of the "
        "serial forms of loop_floor (a rolled loop, its row read from shared memory) and of "
        "slab_scan (the probe's table step: a dependent load, 3 more loads, 4 stores): "
        + ", ".join(f"{k} {v:.3f} ({serial_launches[k]} launch a call)"
                    for k, v in probe_ns.items()) + f"; card {card}")
    # the chunked kernels, bitop_scan's table build and scan and chains'
    # fixed form: no spills in ptxas' log, no local memory in the SASS
    redesigned = ("floor_chunk_kernel", "slab_chunk_kernel", "bitop_table", "chains_fixed_kernel")
    spills = {k: v for name in redesigned for k, v in probe_spills(kernels, name).items()}
    sass = sass_ops(kernels.build_probes()._name,
                    {"floor_chunk_kernel": ("LDL", "STL", "LDG", "STG"),
                     "slab_chunk_kernel": ("LDL", "STL", "LDS", "STG"),
                     "bitop_table": ("LDL", "STL", "LDS", "SHFL", "VOTE", "LDGSTS", "STG"),
                     "chains_fixed_kernel": ("LDL", "STL", "VOTE", "STG")})
    for fn, ops in sass.items():
        log(f"[10] sass {fn[-60:]}: {ops}")
    log(f"[10] ptxas spill bytes of the redesigned kernels {spills}; card {card}")
    # bitop_table_kernel a value of n_ops, bitop_table_scan_kernel, chains'
    # fixed form a C
    extra = [fn for fn in sass if "bitop_table" in fn or "chains_fixed" in fn]
    if len(extra) != len(probe_tpu20.N_OPS) + 1 + len(probe_tpu56.CHAINS):
        raise AssertionError(f"[10] the table and fixed-form instances: {extra}")
    # every instance there: loop_floor's R = C / 8 a C; the slab kernel's
    # (N_OUT, C), slab_scan's N_OUT = 4 and slab_anatomy's 1, 2 and 4 (each
    # source's anonymous namespace gives its instances names of their own)
    found = sorted(re.search(r"(floor|slab)_chunk_kernelILi(\d+)E(?:Li(\d+)E)?", fn).groups()
                   for fn in sass if fn not in extra)
    want = sorted([("floor", str(c // 8), None) for c in kernels.SCAN_CHUNKS]
                  + [("slab", str(n), str(c)) for n in (4, 1, 2, 4) for c in kernels.SCAN_CHUNKS])
    if (any(spills.values()) or found != want
            or any(ops["LDL"] or ops["STL"] for ops in sass.values())):
        raise AssertionError(f"[10] the redesigned kernels spill, use local memory or lack an "
                             f"instance ({found} against {want}): {spills} {sass}")
    placement = {"k2_step_ops": k2_ops, "k2_cycles_a_position": k2_cyc,
                 "bitop_sweep_cycles": dict(sweep), "bitop_fit": [float(slope), float(icpt)],
                 "table_scan_ns_a_chain_step": t3 * 1e6 / n3, "chain_steps": n3,
                 "table_scan_one_string_ns_a_step": t1 * 1e6 / segment, "probe_ns": probe_ns,
                 "serial_launches": serial_launches}
    return {"rows": list(rows.values()), "times": tms, "errs": errs,
            "launches": {"probes": got},
            "rec": {"scripts": recs, "placement": placement, "sass": sass, "spills": spills}}


def sass_ops(lib_path: str, names: dict) -> dict:
    """Counts of the opcodes in ``names`` (function substring -> opcodes)
    in each matching function of a built library's SASS (cuobjdump, from
    nvcc's directory); the SASS goes to chiprun_out/sass/probes.sass."""
    from halo2_regex_tpu_torch.ops import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                         check=True)
    os.makedirs(os.path.join("chiprun_out", "sass"), exist_ok=True)
    with open(os.path.join("chiprun_out", "sass", "probes.sass"), "w") as f:
        f.write(res.stdout)
    out, fn = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            key = next((k for k in names if k in fn), None)
            if key is not None:
                out[fn] = {op: 0 for op in names[key]}
        elif fn in out and "/*" in ln and ";" in ln:
            ins = ln.split("*/", 1)[1].split()
            ins = ins[1:] if ins and ins[0].startswith("@") else ins
            # an opcode with modifiers (STG.128) counts the instructions of
            # that opcode that carry every one of them (STG.E.128)
            parts = ins[0].split(".") if ins else [""]
            for key in out[fn]:
                want = key.split(".")
                if want[0] == parts[0] and all(m in parts[1:] for m in want[1:]):
                    out[fn][key] += 1
    return out


def probe_spills(kernels, name: str) -> dict:
    """Spill bytes (stores + loads) that ptxas reported for each entry of
    the probes library whose mangled name holds ``name``, read from the
    build log kept beside the library (``build.log``: there whether this
    process built it or found it built).  Raises where the log or the
    entry is missing: an unknown spill count is no pass."""
    log_path = os.path.join(os.path.dirname(kernels.build_probes()._name), "build.log")
    if not os.path.exists(log_path):
        raise AssertionError(f"no ptxas log beside the probes library ({log_path})")
    with open(log_path) as f:
        text = f.read()
    out, fn = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if name in ln else None
        elif fn and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill", ln)
            out[fn] = sum(int(x) for x in nums)
    if not out:
        raise AssertionError(f"the ptxas log {log_path} reports no entry holding {name}")
    return out


def table_probe_phase(kernels, chain_ns: float, card: str) -> dict:
    """[11] The table-kernel probes of tools/ (``probes/``: probe_tpu,
    probe_tpu2, probe_tpu3, probe_tpu17, probe_tpu18): each script's ``run``
    at its own widths (probe_tpu2's with the from: batch, B=32768 x L=1024
    time-major, for dfa_step lookup, class_mma and onehot_mma), the launch
    counts reset just before and read just after.  Each kernel line holds a
    kernel against its plain version (``harness.measure``: one call with
    every count read around it, 2 + 10 timed runs, the last output against
    the plain version's; a library call beside it where one computes the
    same function); the scripts' torch lines are timed as they are.  Then
    the lone chain of dependent gathers (lane_gather, [1, 128], one warp)
    is set beside configs[3]'s table-scan chain step of this run, and the
    SASS shows wgmma in the tensor-core kernels (HGMMA in dfa_step's
    products, IGMMA in int8_mma), 16-byte copies and stores in dfa_step's
    lookup (LDGSTS .128, STG.128) and 256 compares a byte in onehot_count
    (HSET2 or HSETP2, two at once), ptxas' log no spills in onehot_count,
    int8_mma, dfa_step (both kernels) and lane_gather's pow form, and that
    form's SASS no local memory (LDL, STL).  lane_gather's 1024-step
    chains run in both forms, the lone chain read from the serial one.
    int8_mma's
    measurements count two launches a call (the staging pass, then the
    product kernel)."""
    from halo2_regex_tpu_torch.probes import (harness, probe_tpu, probe_tpu2, probe_tpu3,
                                              probe_tpu17, probe_tpu18)

    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    recs = (probe_tpu.run(dev) + probe_tpu2.run(dev, big=True) + probe_tpu3.run(dev)
            + probe_tpu17.run(dev) + probe_tpu18.run(dev))
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in kernels.KERNELS + kernels.PROBE_KERNELS}
    if (any(got[k.name] for k in kernels.KERNELS + kernels.SERIAL_PROBES + kernels.EMIT_PROBES)
            or not all(got[k.name] for k in kernels.TABLE_PROBES)):
        raise AssertionError(f"[11] the probe scripts' launches {got}")
    log(f"[11] probe scripts (probe_tpu, probe_tpu2, probe_tpu3, probe_tpu17, probe_tpu18 "
        f"run), launches {dict((k, v) for k, v in got.items() if v)}")

    def label(r) -> str:
        parts = [r["probe"], "x".join(map(str, r.get("shape", [])))]
        parts += [str(r[k]) for k in ("store", "form", "pick", "layout") if r.get(k)]
        return ", ".join(p for p in parts if p)

    tms = {}
    for r in recs:
        lab = label(r)
        if r["kernel"] is None:  # the scripts' torch lines
            extra = "".join(f"; {k} {r[k]:.1f}" for k in ("tflops", "gbytes_per_sec") if k in r)
            log(f"[11] torch {lab}: {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-{r['iqr'][1]:.4f})"
                + extra + (f"; rel_err {r['rel_err']:.5f}" if "rel_err" in r else "")
                + f"; card {card}")
            tms[f"torch[{lab}]"] = {"ms": r["ms"], "iqr": r["iqr"],
                                    **{k: r[k] for k in ("tflops", "gbytes_per_sec") if k in r}}
        elif r["probe"] == "A_dispatch_nop":
            log(f"[11] nop host: {r['host_us_a_call']:.2f} us a call over {r['host_calls']} "
                f"back-to-back calls then one synchronize (x + 1: "
                f"{r['torch_host_us_a_call']:.2f}); card {card}")
    rows, ktms, errs = probe_lines(kernels, [r for r in recs if r["kernel"] is not None],
                                   kernels.TABLE_PROBES, got, label, "[11]", card)
    tms.update(ktms)

    # the lone chain beside configs[3]'s table-scan chain step ([10], this run)
    lone = {r["store"]: r for r in recs
            if r["probe"] == "E_take_along_loop_1x128" and r["form"] == "serial"}
    sh, rg = lone["shared"], lone["regs"]
    log(f"[11] the lone chain of dependent gathers (lane_gather [1, 128], one warp, "
        f"{sh['steps']} steps): shared memory {sh['ns_per_step']:.3f} ns = "
        f"{sh['cycles_per_step']:.1f} cycles a step at {harness.CLOCK_HZ / 1e9:.2f} GHz, "
        f"registers (shuffles) {rg['ns_per_step']:.3f} ns = {rg['cycles_per_step']:.1f}; "
        f"configs[3]'s table scan {chain_ns:.3f} ns a chain step ([10]): "
        f"{chain_ns / sh['ns_per_step']:.3f}x the shared-memory chain; card {card}")
    # the SASS: wgmma in the tensor-core forms (HGMMA for f16, IGMMA for
    # s8; mma.sync would be HMMA), 256 compares a byte in onehot_count:
    # its loop body holds R bytes a thread (its template argument), each
    # compared on half2, two keys an HSET2 or HSETP2 (the ISETPs there are
    # the loops' and the bounds', not compares of a byte)
    sass = sass_ops(kernels.build_probes()._name,
                    {"dfa_kernel": ("HGMMA", "HMMA", "HSET2", "LDS", "ISETP"),
                     "dfa_lookup_kernel": ("LDGSTS.128", "LDGSTS", "STG.128", "STG", "LDS.128",
                                           "LDS"),
                     "int8_mma_kernel": ("IGMMA", "IMMA", "UTMALDG", "UTMASTG"),
                     "onehot_count_kernel": ("ISETP", "HSET2", "HSETP2", "HADD2", "LDS"),
                     "gather_pow_kernel": ("LDL", "STL", "LDS", "SHFL")})
    for fn, ops in sass.items():
        log(f"[11] sass {fn[-60:]}: {ops}")
    mma = {fn: ops for fn, ops in sass.items() if "dfa_kernelILi1" in fn or "dfa_kernelILi2" in fn}
    int8 = {fn: ops for fn, ops in sass.items() if "int8_mma_kernel" in fn}
    per_byte = {fn: 2 * (ops["HSET2"] + ops["HSETP2"])
                / int(re.search(r"onehot_count_kernelILi(\d+)E", fn).group(1))
                for fn, ops in sass.items() if "onehot_count" in fn}
    lookup = {fn: ops for fn, ops in sass.items() if "dfa_lookup_kernel" in fn}
    gpow = {fn: ops for fn, ops in sass.items() if "gather_pow_kernel" in fn}
    spills = {k: v for name in ("onehot_count_kernel", "int8_", "dfa_kernel", "dfa_lookup_kernel",
                                "gather_pow_kernel")
              for k, v in probe_spills(kernels, name).items()}
    log(f"[11] onehot_count compares a byte in the SASS (HSET2 and HSETP2, two each): "
        f"{per_byte}; ptxas spill bytes (onehot_count, int8_mma, dfa_step, lane_gather's pow "
        f"form) {spills}")
    if any(spills.values()):
        raise AssertionError(f"[11] spills: {spills}")
    # lane_gather's pow form, one instance a store: no local memory
    if len(gpow) != 2 or any(ops["LDL"] or ops["STL"] for ops in gpow.values()):
        raise AssertionError(f"[11] lane_gather's pow form lacks an instance or uses local "
                             f"memory: {gpow}")
    # the lookup's 16-byte copies (cp.async, LDGSTS .128) and stores (STG.128)
    if len(lookup) != 2 or not all(ops["LDGSTS.128"] and ops["STG.128"] for ops in lookup.values()):
        raise AssertionError(f"[11] the lookup's SASS lacks 16-byte copies or stores: {lookup}")
    if (len(mma) != 4 or not all(ops["HGMMA"] and not ops["HMMA"] for ops in mma.values())
            or len(int8) != 2 or not all(ops["IGMMA"] and not ops["IMMA"] for ops in int8.values())
            or not per_byte or not all(v >= 256 for v in per_byte.values())):
        raise AssertionError(f"[11] the SASS lacks wgmma or the 256 compares: {sass}")
    placement = {"lone_chain_ns": sh["ns_per_step"], "lone_chain_cycles": sh["cycles_per_step"],
                 "lone_chain_regs_ns": rg["ns_per_step"], "table_scan_ns_a_chain_step": chain_ns}
    return {"rows": list(rows.values()), "times": tms, "errs": errs,
            "launches": {"table_probes": got},
            "rec": {"scripts": recs, "placement": placement, "sass": sass}}


def emit_probe_phase(kernels, card: str) -> dict:
    """[12] The emission and decode probes of tools/ (``probes/``:
    probe_tpu47, probe_tpu48, probe_tpu64, probe_tpu68): each script's
    ``run`` at its own widths (47 and 48 at [8, 8, 1024, 128], 64's A at
    [64, 1024, 128], 64's B and C and 68 on the from: batch, B=32768 x
    L=1024), the launch counts reset just before and read just after.
    Each kernel line holds a kernel against its plain version
    (``harness.measure``: one call with every count read around it, 2 + 10
    timed runs, the last output against the plain version's, tolerance 0;
    the library call beside tile_move); the scripts hold every decode form
    against the torch tail and B14's ``decode`` on the same g4, and each
    witness pipeline's keys against the shipped witness, and raise where
    one differs.  The matcher kernels the scripts run (the witness fronts:
    qpack or pack_raw, scan, post; B14 decode; the shipped kdecode and
    direct walls' post_direct) are the only others launched.  Then B14's
    ms, each field_decode form's and each witness wall are logged side by
    side, and the SASS shows HMMA in the four mma instances of the emit
    kernel and none in the others."""
    from halo2_regex_tpu_torch.probes import (harness, probe_tpu47, probe_tpu48, probe_tpu64,
                                              probe_tpu68)

    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    recs = (probe_tpu47.run(dev) + probe_tpu48.run(dev) + probe_tpu64.run(dev)
            + probe_tpu68.run(dev))
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in kernels.KERNELS + kernels.PROBE_KERNELS}
    path = (kernels.QPACK, kernels.PACK_RAW, kernels.SCAN, kernels.POST, kernels.POST_DIRECT,
            kernels.DECODE)
    if (any(got[k.name] for k in kernels.KERNELS + kernels.SERIAL_PROBES + kernels.TABLE_PROBES
            if k not in path) or not all(got[k.name] for k in kernels.EMIT_PROBES + path)):
        raise AssertionError(f"[12] the probe scripts' launches {got}")
    log(f"[12] probe scripts (probe_tpu47, probe_tpu48, probe_tpu64, probe_tpu68 run), "
        f"launches {dict((k, v) for k, v in got.items() if v)}")

    def label(r) -> str:
        parts = [r["probe"], "x".join(map(str, r.get("shape", []))), r.get("form") or ""]
        return ", ".join(p for p in parts if p)

    tms, errs = {}, {}
    emit_names = {k.name for k in kernels.EMIT_PROBES}
    for r in recs:
        lab = label(r)
        if r["kernel"] is None:  # the scripts' torch lines and witness walls
            if r["device"] != "cuda" or r["card"] != card:
                raise AssertionError(f"[12] torch {lab}: {r}")
            rate = next((f"; {k} {r[k]:.1f}" for k in ("gbytes_per_sec", "input_gbps")
                         if k in r), "")
            rounds = f"; rounds {[round(v, 4) for v in r['round_ms']]}" if "round_ms" in r else ""
            log(f"[12] torch {lab}: {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-{r['iqr'][1]:.4f})"
                + rate + rounds + f"; card {card}")
            tms[f"torch[{lab}]"] = {k: r[k] for k in ("ms", "iqr", "gbytes_per_sec", "input_gbps",
                                                      "round_ms") if k in r}
        elif r["kernel"] not in emit_names:  # B14 and qpack, matcher kernels timed as probes
            if (r["device"] != "cuda" or r["card"] != card or r["launches"] != 1
                    or r["max_abs_err"]):
                raise AssertionError(f"[12] {r['kernel']} [{lab}]: {r}")
            bd = bound(r["nbytes"], r.get("int32_ops", 0))
            errs[f"{r['kernel']}[{lab}]"] = r["max_abs_err"]
            tms[f"{r['kernel']}[{lab}]"] = {"kernel": {"median": r["ms"], "iqr": r["iqr"]},
                                            "plain_ms": r["plain_ms"], **bd}
            log(f"[12] {r['kernel']} [{lab}]: kernel vs plain max_abs_err={r['max_abs_err']} "
                f"(tolerance 0, int32); kernel {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-"
                f"{r['iqr'][1]:.4f}); plain {r['plain_ms']:.4f} ms (1 run); bound "
                f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; 1 launch a call (counted); "
                f"card {card}")
    rows, ktms, kerrs = probe_lines(kernels, [r for r in recs if r["kernel"] in emit_names],
                                    kernels.EMIT_PROBES, got, label, "[12]", card)
    tms.update(ktms)
    errs.update(kerrs)

    # side by side: B14, each field_decode form and each witness wall
    by = {r["probe"]: r for r in recs}
    dec = {"B14 decode (64 b1)": by["b1_kdecode"]["ms"],
           "B14 decode (68 a)": by["a_b14_decode"]["ms"],
           "field_decode mma_pack (64 b2)": by["b2_mxdecode"]["ms"],
           "field_decode mma_select (68 a)": by["a_mma_select_decode"]["ms"],
           "field_decode swap (68 a)": by["a_swap_decode"]["ms"],
           "torch tail (64 b0)": by["b0_xla_tail"]["ms"],
           "one byte transpose (64 b3)": by["b3_xla_onetrans"]["ms"]}
    walls = {r["probe"]: r["ms"] for r in recs if r["probe"].startswith("b_")}
    log(f"[12] decode at B={B} x L={L} (ms): "
        + "; ".join(f"{k} {v:.4f}" for k, v in dec.items())
        + f" (bound {tms['decode[b1_kdecode, 32768x1024]']['bound_ms']:.4f}); witness walls "
        f"(ms, in turns): " + "; ".join(f"{k} {v:.4f}" for k, v in walls.items())
        + f"; tile transpose {by['pallas_tile_T']['ms']:.4f} against copy "
        f"{by['pallas_copy']['ms']:.4f} at 33.5 MB; card {card}")
    # the SASS: mma.sync (HMMA) in the four tensor-core instances only
    sass = sass_ops(kernels.build_probes()._name,
                    {"emit_kernel": ("HMMA", "PRMT", "LDS", "STS"),
                     "tile_move_kernel": ("LDS", "STS", "LDG", "STG")})
    for fn, ops in sass.items():
        log(f"[12] sass {fn[-60:]}: {ops}")
    mma = {fn: ops for fn, ops in sass.items()
           if "emit_kernelILi2" in fn or "emit_kernelILi3" in fn}
    if (len(mma) != 4 or not all(ops["HMMA"] for ops in mma.values())
            or any(ops["HMMA"] for fn, ops in sass.items() if "emit_kernel" in fn and fn not in mma)
            or len([fn for fn in sass if "tile_move" in fn]) != 2):
        raise AssertionError(f"[12] the SASS lacks mma.sync in the mma forms: {sass}")
    return {"rows": list(rows.values()), "times": tms, "errs": errs,
            "launches": {"emit_probes": got},
            "rec": {"scripts": recs, "decode_ms": dec, "walls_ms": walls, "sass": sass}}


def t2_probe_phase(kernels, m3, chars3, card: str) -> dict:
    """[13] The launch, accumulate, carry, class-chain and configs[3]
    table-step probes of tools/ (``probes/``: probe_tpu21, 20 D and E, 6,
    67, 7, 28, 30, 31, 32): each script's ``run`` at its own widths, and the
    widened step (dfa_wide, lookup and onehot_mma) at configs[3]'s batch
    (B=64 x L=65536, its 96 x 1008 table) beside B8's table scan on the
    same table, the launch counts reset just before and read just after
    (the chunked lookup at configs[3] two launches a call).
    Each kernel line holds a kernel against its plain version
    (``harness.measure``: one call with every count read around it, 2 + 10
    timed runs, the last output against the plain version's: int32 outputs
    exactly, mma_accum exactly on integer inputs and within 2e-5 x sum |a b|
    on N(0, 1) inputs; a library call beside it where one computes the same
    function).  Of the other kernels only those the scripts reuse run:
    loop_floor (k1), slab_anatomy (k3), tile_move (probe_tpu67's A), the
    witness kernels (its C) and the table scan (B8 at configs[3]).  Then
    the launch cost past the bytes, the forms of each family and B8 are
    logged side by side (with the lookup's form and repaired positions
    beside B8's, held to its twin's count), the SASS shows HGMMA and no
    HMMA in mma_accum and every instance of dfa_wide's product, neither in
    its lookup, and ptxas no spills in either."""
    from halo2_regex_tpu_torch.probes import (harness, probe_tpu6, probe_tpu7, probe_tpu20,
                                              probe_tpu21, probe_tpu28, probe_tpu30, probe_tpu31,
                                              probe_tpu32, probe_tpu67)

    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    scripts = (
        ("probe_tpu28", lambda: probe_tpu28.configs3_lines(
            dev, m3.next_table[0], m3.class_map[0], chars3, int(m3.first_states[0]))),
        ("probe_tpu21", lambda: probe_tpu21.run(dev)),
        ("probe_tpu20", lambda: probe_tpu20.run_de(dev)),
        ("probe_tpu6", lambda: probe_tpu6.run(dev)),
        ("probe_tpu67", lambda: probe_tpu67.run(dev)),
        ("probe_tpu7", lambda: probe_tpu7.run(dev)),
        ("probe_tpu28", lambda: probe_tpu28.run(dev)),
        ("probe_tpu30", lambda: probe_tpu30.run(dev)),
        ("probe_tpu31", lambda: probe_tpu31.run(dev)),
        ("probe_tpu32", lambda: probe_tpu32.run(dev)),
    )
    recs = []
    for script, fn in scripts:
        recs += [dict(r, script=script) for r in fn()]
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in kernels.KERNELS + kernels.PROBE_KERNELS}
    reused = (kernels.LOOP_FLOOR, kernels.SLAB_ANATOMY, kernels.TILE_MOVE, kernels.TABLE_SCAN,
              kernels.QPACK, kernels.SCAN, kernels.POST)
    every = kernels.KERNELS + kernels.PROBE_KERNELS
    if (any(got[k.name] for k in every if k not in kernels.T2_PROBES + reused)
            or not all(got[k.name] for k in kernels.T2_PROBES + reused)):
        raise AssertionError(f"[13] the probe scripts' launches {got}")
    log(f"[13] probe scripts (probe_tpu28.configs3_lines, probe_tpu21, probe_tpu20.run_de, "
        f"probe_tpu6, probe_tpu67, probe_tpu7, probe_tpu28, probe_tpu30, probe_tpu31, "
        f"probe_tpu32 run), launches {dict((k, v) for k, v in got.items() if v)}")

    def label(r) -> str:
        parts = [r["script"], r["probe"], "x".join(map(str, r.get("shape", [])))]
        parts += [str(r[k]) for k in ("form", "inputs", "start", "table") if r.get(k)]
        if r.get("reads"):
            parts.append(f"reads {r['reads']}")
        return ", ".join(p for p in parts if p)

    tms, errs = {}, {}
    t2_names = {k.name for k in kernels.T2_PROBES}
    for r in recs:
        lab = label(r)
        if r["kernel"] is None:  # probe_tpu67's witness walls
            if r["device"] != "cuda" or r["card"] != card:
                raise AssertionError(f"[13] torch {lab}: {r}")
            log(f"[13] torch {lab}: {r['ms']:.4f} ms a call (IQR {r['iqr'][0]:.4f}-"
                f"{r['iqr'][1]:.4f}; the wall slope of {r['ks']} chained calls, host enqueue "
                f"included; device slope {r['device_slope_ms']['median']:.4f}); "
                f"{r['input_gbps']:.1f} GB/s of input; card {card}")
            tms[f"torch[{lab}]"] = {k: r[k] for k in ("ms", "iqr", "input_gbps", "wall_ms",
                                                      "device_slope_ms")}
        elif r["kernel"] not in t2_names:  # the kernels of earlier slices the scripts reuse
            if (r["device"] != "cuda" or r["card"] != card or r["launches"] != r.get("calls", 1)
                    or r["max_abs_err"]):
                raise AssertionError(f"[13] {r['kernel']} [{lab}]: {r}")
            bd = bound(r["nbytes"], r.get("int32_ops", 0))
            errs[f"{r['kernel']}[{lab}]"] = r["max_abs_err"]
            tms[f"{r['kernel']}[{lab}]"] = {"kernel": {"median": r["ms"], "iqr": r["iqr"]},
                                            "plain_ms": r["plain_ms"],
                                            "library_ms": r["library_ms"], **bd}
            lib = r["library_ms"]
            log(f"[13] {r['kernel']} [{lab}]: kernel vs plain max_abs_err={r['max_abs_err']} "
                f"(tolerance 0, int32); kernel {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-"
                f"{r['iqr'][1]:.4f}); plain {r['plain_ms']:.4f} ms (1 run)"
                + (f"; library {lib:.4f} ms" if lib is not None else "")
                + f"; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; {r['launches']} "
                f"launch(es) a call (counted); card {card}")
    for r in recs:
        if r["kernel"] == "mma_accum" and "library_max_abs_err" in r:
            log(f"[13] mma_accum [{label(r)}]: the library (bf16 products) differs from the "
                f"plain version by {r['library_max_abs_err']:.6g} (recorded, not held)")
    rows, ktms, kerrs = probe_lines(kernels, [r for r in recs if r["kernel"] in t2_names],
                                    kernels.T2_PROBES, got, label, "[13]", card)
    tms.update(ktms)
    errs.update(kerrs)

    # side by side: a launch past its bytes, the step's forms beside B8
    for r in recs:
        if r["probe"].startswith("a_copy"):
            for name in ("chain", "clone_chain"):
                c = r[name]
                log(f"[13] {r['probe']} {name} (K = {c['ks'][0]} and {c['ks'][1]}, L2 flushed, "
                    f"no spin): wall slope {c['slope_ms']['median'] * 1e3:.2f} us a call (IQR "
                    f"{c['slope_ms']['iqr'][0] * 1e3:.2f}-{c['slope_ms']['iqr'][1] * 1e3:.2f}), "
                    f"less the bytes at {c['copy_gbps']} GB/s ({c['bytes_ms'] * 1e3:.2f} us): "
                    f"{c['fixed_ms'] * 1e3:.2f} us; device slope "
                    f"{c['device_slope_ms']['median'] * 1e3:.2f} us (fixed "
                    f"{c['device_fixed_ms'] * 1e3:.2f} us); card {card}")
    c3 = {r["form"]: r["ms"] for r in recs if r["probe"] in ("configs3", "configs3_b8")}
    log(f"[13] configs[3]'s step at B={B3} x L={L3} (ms): "
        + "; ".join(f"{k} {v:.4f}" for k, v in c3.items()) + f"; card {card}")
    lk = next(r for r in recs if r["probe"] == "configs3" and r["form"] == "lookup")
    b8r = next(r for r in recs if r["probe"] == "configs3_b8")
    log(f"[13] configs[3]'s lookup: form {'chunked' if lk['cw'][0] else 'serial'} (C, W) = "
        f"{tuple(lk['cw'])}, {lk['repaired']} positions repaired in a call (its twin "
        f"{lk.get('repaired_twin')}, twin vs plain max_abs_err={lk.get('twin_max_abs_err')}); "
        f"B8 {b8r['form']} (C, W) = {tuple(b8r['cw'])}, {b8r['repaired']} repaired; card {card}")
    if lk["cw"][0] and (lk["repaired"] != lk["repaired_twin"] or lk["twin_max_abs_err"]):
        raise AssertionError(f"[13] the chunked lookup disagrees with its twin: {lk}")
    # the SASS: wgmma (HGMMA) in both tile widths of mma_accum and in every
    # k-tile instance of dfa_wide's product, mma.sync (HMMA) in neither, no
    # matrix instruction in dfa_wide's lookup
    sass = sass_ops(kernels.build_probes()._name,
                    {"mma_accum_tma_kernel": ("HGMMA", "HMMA"),
                     "wide_mma_kernel": ("HGMMA", "HMMA", "LDS"),
                     "wide_lookup_kernel": ("HGMMA", "HMMA", "LDS", "LDG"),
                     "wide_repair_kernel": ("HGMMA", "HMMA", "LDS", "LDG"),
                     "class_chain_kernel": ("ISETP", "LDS"), "bitop_carry_kernel": ("LOP3",),
                     "bitop_carry_reduce_kernel": ("LDG.E.128", "LDG", "LOP3", "LDL", "STL")})
    for fn, ops in sass.items():
        log(f"[13] sass {fn[-60:]}: {ops}")
    mma = {k: [(ops["HGMMA"] > 0, ops["HMMA"] > 0) for fn, ops in sass.items() if k in fn]
           for k in ("mma_accum_tma_kernel", "wide_mma_kernel", "wide_lookup_kernel",
                     "wide_repair_kernel")}
    spills = {**probe_spills(kernels, "mma_accum_tma_kernel"), **probe_spills(kernels, "wide_"),
              **probe_spills(kernels, "bitop_carry_reduce_kernel")}
    log(f"[13] mma_accum, dfa_wide and bitop_carry's reduce form ptxas spill bytes {spills}")
    if any(spills.values()):
        raise AssertionError(f"[13] spills: {spills}")
    # bitop_carry: LOP3 in the serial kernel; the reduce kernel's two
    # instances (V = 4, 1), 16-byte loads in V = 4's, no local memory
    serial = [ops for fn, ops in sass.items() if "bitop_carry_kernel" in fn]
    red = {fn: ops for fn, ops in sass.items() if "bitop_carry_reduce_kernel" in fn}
    red4 = [ops for fn, ops in red.items() if "ILi4E" in fn]
    if (len(serial) != 1 or not serial[0]["LOP3"] or len(red) != 2 or len(red4) != 1
            or not red4[0]["LDG.E.128"] or any(ops["LDL"] or ops["STL"] for ops in red.values())):
        raise AssertionError(f"[13] bitop_carry's SASS lacks LOP3 in its serial kernel or "
                             f"16-byte loads in its reduce kernel, or uses local memory: {sass}")
    if (len(mma["mma_accum_tma_kernel"]) != 2 or not all(h for h, _ in mma["mma_accum_tma_kernel"])
            or not mma["wide_mma_kernel"] or set(mma["wide_mma_kernel"]) != {(True, False)}
            or not mma["wide_lookup_kernel"] or not mma["wide_repair_kernel"]
            or set(mma["wide_lookup_kernel"] + mma["wide_repair_kernel"]) != {(False, False)}):
        raise AssertionError(f"[13] the SASS lacks wgmma in mma_accum or dfa_wide's product, or "
                             f"holds mma.sync: {sass}")
    return {"rows": list(rows.values()), "times": tms, "errs": errs,
            "launches": {"t2_probes": got},
            "rec": {"scripts": recs, "configs3_ms": c3, "sass": sass}}


def t2c_probe_phase(kernels, times: dict, card: str) -> dict:
    """[14] The marker-stream probes of tools/ (``probes/``: probe_tpu57 B,
    C, D, E and probe_tpu61 C), the launch counts reset just before and
    read just after.  Each marker_match line holds the kernel (serial and
    at each chunk length) against its plain version (``harness.measure``:
    one call with every count read around it, 2 + 10 timed runs, the last
    output against the plain verdict, tolerance 0) and the scripts hold
    every verdict against Python ``re``'s; K2 with the probe's plan is held
    against its plain scan; D's two matchers (the from: model at 64 KB) and
    E's two witness plans (the 200-word model) against the C++ oracle's
    rows.  Of the other kernels only those the scripts reuse run: pack_raw
    and the scan (B, C), the path kernels of D's and E's witness plans
    (``kernels.path_kernels``), the table kernels (D's PallasMatcher).  Then the
    verdict's forms are logged beside K2 and the match path's wall of this
    run ([4], [6]), and probe_tpu61's chain slopes beside them.  The SASS
    shows the chunked form reading the stack by TMA alone (UTMALDG, no LDG)
    in each chunk length's instance, and ptxas' log no spills in it."""
    from halo2_regex_tpu_torch.probes import probe_tpu57, probe_tpu57_lib, probe_tpu61

    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    recs = [dict(r, script="probe_tpu57") for r in probe_tpu57.run(dev)]
    recs += [dict(r, script="probe_tpu61") for r in probe_tpu61.run(dev)]
    torch.cuda.synchronize()
    got = {k.name: k.launches for k in kernels.KERNELS + kernels.PROBE_KERNELS}
    plans = [probe_tpu57.d_matchers(probe_tpu57.D_SHAPE[1], dev)["bitplane"].plan]
    plans += [m.plan for m in probe_tpu57.e_matchers(dev).values()]
    reused = tuple(dict.fromkeys(
        (kernels.PACK_RAW, kernels.SCAN, kernels.TABLE_SCAN, kernels.TABLE_TAG,
         kernels.TABLE_FSM) + sum((kernels.path_kernels(p) for p in plans), ())))
    every = kernels.KERNELS + kernels.PROBE_KERNELS
    if (any(got[k.name] for k in every if k not in kernels.T2C_PROBES + reused)
            or not all(got[k.name] for k in kernels.T2C_PROBES + reused)):
        raise AssertionError(f"[14] the probe scripts' launches {got}")
    log(f"[14] probe scripts (probe_tpu57, probe_tpu61 run), launches "
        f"{dict((k, v) for k, v in got.items() if v)}")

    def label(r) -> str:
        parts = [r["script"], r["probe"], "x".join(map(str, r.get("shape", []))), r.get("form")]
        return ", ".join(p for p in parts if p)

    tms, errs = {}, {}
    for r in recs:
        lab = label(r)
        if r["device"] != "cuda" or r["card"] != card:
            raise AssertionError(f"[14] {lab}: {r}")
        if "ks" in r:  # probe_tpu61's chain slopes
            if not r.get("kept"):
                raise AssertionError(f"[14] {lab}: no round above the floor: {r}")
            sl = r["device_slope_ms"]
            log(f"[14] slope {lab}: median {r['median_ms']:.4f} ms, best {r['best_ms']:.4f} "
                f"({r['kept']} of {r['runs']} rounds over the floor {r['floor_ms']:.4f} ms at "
                f"{r['copy_gbps']} GB/s; device slopes {[round(v, 4) for v in sl['all']]}; "
                f"chains of {r['ks']} over {r['copies']} copies; wall slope "
                f"{r['slope_ms']['median']:.4f}); card {card}")
            tms[f"slope[{lab}]"] = {k: r[k] for k in ("median_ms", "best_ms", "floor_ms", "kept",
                                                      "device_slope_ms", "slope_ms")}
        elif r["kernel"] is None:  # the plain verdict, D's and E's walls
            rate = f"; {r['input_gbps']:.3f} GB/s of input" if "input_gbps" in r else ""
            held = ("equals re" if r.get("equals_re")
                    else f"{r['equals_oracle_rows']} rows equal the C++ oracle")
            log(f"[14] torch {lab}: {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-{r['iqr'][1]:.4f})"
                f"{rate}; {held}; card {card}")
            tms[f"torch[{lab}]"] = {k: r[k] for k in ("ms", "iqr", "input_gbps") if k in r}
        elif r["kernel"] != kernels.MARKER_MATCH.name:  # K2 with the probe's plan
            if r["launches"] != 1 or r["max_abs_err"]:
                raise AssertionError(f"[14] {r['kernel']} [{lab}]: {r}")
            bd = bound(r["nbytes"], r.get("int32_ops", 0))
            errs[f"{r['kernel']}[{lab}]"] = r["max_abs_err"]
            tms[f"{r['kernel']}[{lab}]"] = {"kernel": {"median": r["ms"], "iqr": r["iqr"]},
                                            "plain_ms": r["plain_ms"], **bd}
            log(f"[14] {r['kernel']} [{lab}]: kernel vs plain max_abs_err={r['max_abs_err']} "
                f"(tolerance 0, int32); kernel {r['ms']:.4f} ms (IQR {r['iqr'][0]:.4f}-"
                f"{r['iqr'][1]:.4f}); plain {r['plain_ms']:.4f} ms (1 run); bound "
                f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; 1 launch a call (counted); "
                f"card {card}")
    rows, ktms, kerrs = probe_lines(
        kernels, [r for r in recs if r["kernel"] == kernels.MARKER_MATCH.name and "ks" not in r],
        kernels.T2C_PROBES, got, label, "[14]", card)
    tms.update(ktms)
    errs.update(kerrs)

    # side by side: the verdict's forms, K2 and the match path's wall
    by = {(r["script"], r["probe"]): r for r in recs}
    side = {}
    for tag, nb in (("b", B), ("c", B_LATENCY)):
        v = {f: by[("probe_tpu57", f"{tag}_marker_{f}")]["ms"]
             for f in ["serial"] + [f"chunk{c}" for c in probe_tpu57_lib.CHUNKS]}
        v["plain"] = by[("probe_tpu57", f"{tag}_marker_plain")]["ms"]
        v["K2 (the probe's plan)"] = by[("probe_tpu57", f"{tag}_scan_kernel")]["ms"]
        side[nb] = v
        bd = bound(10 * L * nb // 32 * 4 + nb // 32 * 4, 0)
        log(f"[14] the verdict at B={nb} x L={L} (ms): "
            + "; ".join(f"{k} {x:.4f}" for k, x in v.items())
            + (f"; K2 ([4], the default plan) {times['scan']['kernel']['median']:.4f}; the match "
               f"path's wall ([6]) {times['end_to_end_match']['kernel']['median']:.4f}"
               if nb == B else "")
            + f"; the marker's bound {bd['bound_ms']:.4f} ({bd['bound_by']}); card {card}")
    d = {r["probe"]: r["ms"] for r in recs if r["probe"].startswith(("d_", "e_"))}
    log(f"[14] D (from: at 4096 x 65536) and E (the 200-word model at {B} x {L}) walls (ms): "
        + "; ".join(f"{k} {x:.4f}" for k, x in d.items()) + f"; card {card}")
    sass = sass_ops(kernels.build_probes()._name,
                    {"marker_chunked_kernel": ("UTMALDG", "LDG", "LDS", "LOP3")})
    spills = probe_spills(kernels, "marker_")
    log(f"[14] sass {sass}; ptxas spill bytes (marker_match) {spills}")
    if any(spills.values()):
        raise AssertionError(f"[14] spills: {spills}")
    if (len(sass) != len(probe_tpu57_lib.CHUNKS)
            or not all(ops["UTMALDG"] and not ops["LDG"] for ops in sass.values())):
        raise AssertionError(f"[14] the chunked marker's SASS lacks TMA loads: {sass}")
    return {"rows": list(rows.values()), "times": tms, "errs": errs,
            "launches": {"t2c_probes": got},
            "rec": {"scripts": recs, "verdict_ms": side, "walls_ms": d, "sass": sass}}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch import cli, native
    from halo2_regex_tpu_torch.ops import bitplane as bp
    from halo2_regex_tpu_torch.ops import kernels
    from halo2_regex_tpu_torch.ops import pallas_scan as ps
    from halo2_regex_tpu_torch.ops.reference import extract_substrings, match_substrs
    from halo2_regex_tpu_torch.utils.io import batch_iterator, pack_lines

    rec: dict = {}
    dev = torch.device("cuda")
    card = smi()
    rec["card"] = card
    rec["versions"] = versions()
    log(f"[1] card: {card}")
    log(f"[1] versions: {json.dumps(rec['versions'])}")

    # [2] one matcher per path; the kernel libraries built at once
    t0 = time.perf_counter()
    model = h2r.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    model_u = h2r.zoo.email_headers_model(max_chars_size=L_UNPADDED, headers=("from",))
    model3, chars3_np, lengths3_np = config3(h2r)
    model_d = h2r.zoo.dictionary_model(40, max_chars_size=L)
    t_model = time.perf_counter() - t0
    matchers = {
        "witness": h2r.BitplaneMatcher(model, columns="witness"),
        "match": h2r.BitplaneMatcher(model, columns="match"),
        "full": h2r.BitplaneMatcher(model),
        "L1000": h2r.BitplaneMatcher(model_u, columns="witness"),
        "tiled_witness": h2r.BitplaneMatcher(model, columns="witness", input_layout="tiled"),
        "tiled_match": h2r.BitplaneMatcher(model, columns="match", input_layout="tiled"),
    }
    # the table paths, and the bitplane backend pallas_from and pallas_dict
    # are held to; pallas_dict's split-mode equivalent, timed beside it
    tables = {
        "pallas_large": h2r.PallasMatcher(model3, max_pairs=4096),
        "pallas_from": h2r.PallasMatcher(model),
        "pallas_dict": h2r.PallasMatcher(model_d),
    }
    full32 = h2r.BitplaneMatcher(model, compact=False)
    dict32 = h2r.BitplaneMatcher(model_d, compact=False)
    dict_split = h2r.PallasMatcher(model_d, max_pairs=4096)
    if matchers["full"].columns != "full" or matchers["L1000"].plan.qpack:
        raise AssertionError("default columns or the L=1000 pack route changed")
    if any(m.device.type != "cuda" for m in (*matchers.values(), *tables.values())):
        raise AssertionError("a matcher built without a device is not on the card")
    m3, mf, md = tables["pallas_large"], tables["pallas_from"], tables["pallas_dict"]
    if (md.mode, md.grid_mode, [len(p) for p in md.pair_info], md.S) != (
            "monolithic", "batch", [211], 184) or dict_split.mode != "split":
        raise AssertionError("dict40 no longer resolves to monolithic (211 pairs, S=184)")
    if (m3.hi_lo, m3.mode, m3.grid_mode, m3.segment, m3.n_seg, tuple(m3.next_table.shape),
            tuple(m3.pairs.shape)) != (True, "split", "segmented", 4096, 16, (1, 96, 1008),
                                       (1, 0, 5)):
        raise AssertionError("configs[3] no longer sizes as in JAX (16 x 4096, 96 classes)")
    if (mf.mode, mf.grid_mode) != ("split", "batch"):
        raise AssertionError("the from: table path is no longer split/batch")
    # the portable scan: best_matcher's third rung on the from: model, and
    # BatchMatcher on configs[3] (run_benchmarks.py's bench3 fallback)
    xla, xla_name = h2r.best_matcher(model, backend="xla")
    xla_large = h2r.BatchMatcher(model3)
    portable = {"xla": xla, "xla_large": xla_large}
    if xla_name != "xla" or not isinstance(xla, h2r.BatchMatcher) or any(
            m.device.type != "cuda" for m in portable.values()):
        raise AssertionError("best_matcher(backend='xla') is not a BatchMatcher on the card")
    if tuple(xla_large.next_table.shape) != (1, 96, 1008):
        raise AssertionError("configs[3]'s portable class table is no longer 96 x 1008")
    # the knob paths, and the 3-def email model whose defs scan_planes runs
    knob_ms = {p: h2r.BitplaneMatcher(model, columns=c, **kw) for p, (c, kw) in KNOB_PATHS.items()}
    # tpack's other class-stage modes (checked in [4]; no path of their own)
    tiled_modes = {mode: h2r.BitplaneMatcher(model, columns="witness", input_layout="tiled",
                                             class_stage=cs_).plan
                   for mode, cs_ in (("class_off", False), ("onehot", "onehot"))}
    hdr = h2r.BitplaneMatcher(h2r.zoo.email_headers_model(max_chars_size=L), columns="match")
    resolved = {p: (m.plan.emit, m.plan.post, m.plan.fuse_pack, m.plan.class_stage, m.plan.kp,
                    m.plan.en_pack, m.plan.unroll) for p, m in knob_ms.items()}
    if ([resolved[p][0] for p in ("witness_direct", "witness_kdecode", "witness_planes")]
            != ["direct", "kdecode", "planes"] or not resolved["witness_fuse_pack"][2]
            or resolved["witness_class_off"][3:5] != (False, 8)
            or resolved["witness_onehot"][3] != "onehot" or resolved["match_en_off"][5]
            or [resolved[f"witness_unroll{u}"][6] for u in (1, 2, 4, 8)] != [1, 2, 4, 8]
            or hdr.plan.n_defs != 3):
        raise AssertionError(f"a knob path no longer resolves as named: {resolved}")
    t0 = time.perf_counter()
    builds = [lambda p=m.plan: kernels.build(p)
              for m in (*matchers.values(), full32, dict32, *knob_ms.values(), hdr)]
    builds += [lambda p=p: kernels.build(p) for p in tiled_modes.values()]
    # [12]'s from: witness front with the pack from raw quads and the torch
    # enable plane (probe_tpu64's B: en_pack=False, qpack=False)
    builds += [lambda: kernels.build(h2r.BitplaneMatcher(
        model, columns="witness", emit="bytes", en_pack=False, qpack=False).plan)]
    builds += [lambda d=d: kernels.build_scan_def(hdr.plan, d) for d in range(hdr.plan.n_defs)]
    # [14]'s matchers: D's witness at 64 KB, E's two witness plans (the
    # 200-word model compiles here, beside the nvcc builds)
    from halo2_regex_tpu_torch.probes import probe_tpu57
    builds += [lambda: kernels.build(probe_tpu57.d_matchers(probe_tpu57.D_SHAPE[1],
                                                            dev)["bitplane"].plan)]

    def build_e():
        ms = probe_tpu57.e_matchers(dev)
        with ThreadPoolExecutor(len(ms)) as pool:
            list(pool.map(lambda m: kernels.build(m.plan), ms.values()))

    builds.append(build_e)
    builds += [kernels.build_tables, kernels.build_probes]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda f: f(), builds))
    t_build = time.perf_counter() - t0
    regs = []  # per library: its header's defines, then each entry's registers and spills
    for key, info in kernels.BUILD_LOG.items():
        regs.append(f"library {key}: {'; '.join(info.get('defines', [])) or 'table kernels'}")
        regs += [ln.strip() for ln in str(info.get("ptxas", "")).splitlines()
                 if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    rec["build"] = {"seconds": t_build, "libraries": {
        k: {"seconds": v["seconds"], "dir": v["dir"]} for k, v in kernels.BUILD_LOG.items()},
        "ptxas": regs}
    log(f"[2] {len(kernels.BUILD_LOG)} kernel libraries built at once in {t_build:.1f} s "
        f"(each {[round(v['seconds'], 1) for v in kernels.BUILD_LOG.values()]} s)")
    for ln in regs:
        log(f"[2]   {ln}")
    plan = matchers["witness"].plan
    c = plan.circuits[0]
    log(f"[3] models compiled in {t_model:.1f} s: step {c.step_ops} ops, "
        f"{len(c.live_states)} live states, sb={c.sb}, KP={plan.kp}, "
        f"class {c.class_prog.n_ops} ops, tag {c.tag_ops} ops, "
        f"groups {[[n for n, _o, _b in g] for g in plan.wgroups]}, "
        f"full post planes {list(matchers['full'].plan.post_off)}")
    table_io_b = {"pallas_large": B3, "pallas_from": B, "pallas_dict": B}
    for path, m in tables.items():
        nb_ = table_io_b[path]
        log(f"[3] {path}: S={m.S}, hi_lo={m.hi_lo}, {m.mode}/{m.grid_mode}, JAX's window "
            f"{m.window} x {m.L // m.window} (the card: one pass over L; at B={nb_} the scan "
            f"form (C, W) {kernels.table_scan_form(m.n_defs, nb_, m.L, dev)}, the FSMs' chunk "
            f"{kernels.table_fsm_form(nb_, dev)}), next table {tuple(m.next_table.shape)}, "
            f"pairs {tuple(m.pairs.shape)}, table in shared memory: "
            f"{kernels.table_smem_bytes(*m.next_table.shape[1:], dev)} B")
    for path, m in portable.items():
        nb_ = B3 if path == "xla_large" else B
        log(f"[3] {path}: BatchMatcher, S={m.model.s_pad}, class table "
            f"{tuple(m.next_table.shape)} (the rows of model.transition), in shared memory: "
            f"{kernels.table_smem_bytes(*m.next_table.shape[1:], dev)} B; at B={nb_} the scan "
            f"form (C, W) {kernels.table_scan_form(m.n_defs, nb_, m.L, dev)}")
    t0 = time.perf_counter()
    corpora = {L: bench_corpus(B, L), L_UNPADDED: bench_corpus(B, L_UNPADDED)}
    log(f"[3] corpora B={B} x L={L} and L={L_UNPADDED} built in "
        f"{time.perf_counter() - t0:.1f} s")
    inputs = {Lc: (torch.from_numpy(c_).to(dev), torch.from_numpy(l_).to(dev))
              for Lc, (c_, l_) in corpora.items()}
    chars, lengths = inputs[L]
    chars_u, lengths_u = inputs[L_UNPADDED]
    chars3 = torch.from_numpy(chars3_np).to(dev)
    lengths3 = torch.from_numpy(lengths3_np).to(dev)
    pt = matchers["tiled_witness"].plan
    t0 = time.perf_counter()
    tiled = torch.from_numpy(h2r.tile_corpus(corpora[L][0], pt.L_pad)).to(dev)
    log(f"[3] tile_corpus of the B={B} corpus -> {tuple(tiled.shape)} {tiled.dtype} in "
        f"{time.perf_counter() - t0:.2f} s (native packer: {native.available()})")
    words = [w.encode() for w in
             h2r.zoo.dictionary_config(40)["parts"][1]["regex_def"][1:-1].split("|")]
    dict_np = dict_corpus(B, L, words)
    chars_d, lengths_d = (torch.from_numpy(a).to(dev) for a in dict_np)

    # [4] each kernel against its plain version on the same inputs
    pf, pm, pu = (matchers[k].plan for k in ("full", "match", "L1000"))
    len_wb = bp.len_table(lengths)
    len_wb_u = bp.len_table(lengths_u)
    quads_u = bp.raw_quads(chars_u, pu.L_pad)
    bits_p, en_p = bp.qpack_plain(plan, chars, len_wb)
    logs_p = bp.scan_plain(plan, bits_p)
    stages = {
        "qpack": (kernels.QPACK, lambda: kernels.qpack_cuda(plan, chars, len_wb),
                  lambda: bp.qpack_plain(plan, chars, len_wb)),
        "scan": (kernels.SCAN, lambda: kernels.scan_cuda(plan, bits_p),
                 lambda: bp.scan_plain(plan, bits_p)),
        "post": (kernels.POST, lambda: kernels.post_cuda(plan, logs_p, en_p),
                 lambda: bp.post_plain(plan, logs_p, en_p)),
        "fb_only": (kernels.FB_ONLY, lambda: kernels.fb_only_cuda(pm, logs_p, en_p),
                    lambda: bp.fb_only_plain(pm, logs_p, en_p)),
        "post_planes": (kernels.POST_PLANES, lambda: kernels.post_planes_cuda(pf, logs_p, en_p),
                        lambda: bp.post_planes_plain(pf, logs_p, en_p)),
        "pack_raw": (kernels.PACK_RAW, lambda: kernels.pack_raw_cuda(pu, quads_u, len_wb_u),
                     lambda: bp.pack_plain(pu, quads_u, len_wb_u)),
        # the tiled witness plan has the witness plan's circuits: its pack
        # equals qpack's planes, so the scan's log planes feed its post
        "tpack": (kernels.TPACK, lambda: kernels.tpack_cuda(pt, tiled, len_wb),
                  lambda: bp.tpack_plain(pt, tiled, len_wb)),
        "post_tiled": (kernels.POST_TILED, lambda: kernels.post_tiled_cuda(pt, logs_p, en_p, tiled),
                       lambda: bp.post_plain(pt, logs_p, en_p, tiled)),
    }
    # bounds from this run's inputs: bytes read once and written once;
    # operations = the circuit ops each word runs per position
    words = B // 32
    ops_of = {n: sum(f(c) for c in plan.circuits) * plan.L_pad * words
              for n, f in (("class", lambda c: c.class_prog.n_ops),
                           ("step", lambda c: c.step_ops), ("tag", lambda c: c.tag_ops))}
    plane = plan.L_pad * words * 4
    bounds = {
        "qpack": bound(B * L + nbytes(len_wb) + plane * (plan.kp + 1), ops_of["class"]),
        "pack_raw": bound(nbytes(quads_u, len_wb_u) + pu.L_pad * words * 4 * (pu.kp + 1),
                          ops_of["class"]),
        "scan": bound(plane * (plan.kp + plan.sb_sum), ops_of["step"]),
        "post": bound(plane * (plan.sb_sum + 1 + 8 * plan.n_groups)
                      + words * plan.n_defs * 8 * 4, ops_of["tag"]),
        "post_planes": bound(plane * (plan.sb_sum + 1 + pf.p_total), ops_of["tag"]),
        "fb_only": fb_bound(pm, en_p),
        "tpack": bound(nbytes(tiled, len_wb) + plane * (pt.kp + 1), ops_of["class"]),
        # the tags, plus the masked characters: 8 byte-bit planes of 8
        # shift-and-or terms each, and 8 ANDs with the mask, per word
        "post_tiled": bound(plane * (pt.sb_sum + 1 + 8 * pt.n_groups) + nbytes(tiled)
                            + words * pt.n_defs * 8 * 4,
                            ops_of["tag"] + (8 * 8 * 3 + 8) * pt.L_pad * words),
    }
    errs = {}
    for name, (k, run_k, run_p) in stages.items():
        want = (bits_p, en_p) if name == "qpack" else (logs_p if name == "scan" else run_p())
        got = run_k()
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, want)
        if name == "tpack" and max_abs_err(want, (bits_p, en_p)) != 0:
            raise AssertionError("tpack_plain of the tiled corpus differs from qpack_plain")
        log(f"[4] {name}: kernel vs plain max_abs_err={errs[name]} "
            f"(tolerance 0, integer outputs); bound {bounds[name]['bound_ms']:.4f} ms "
            f"by {bounds[name]['bound_by']}")
        if errs[name] != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain version")
        del got, want
    # the quad-word pack (pack_raw, tpack: one kernel) in its other modes
    # and both layouts: pack_raw on the L=1024 corpus's raw quad rows (the
    # qpack=False route) under the default and knob plans, tpack on the
    # tiled corpus under tiled plans of each class stage
    quads_l = bp.raw_quads(chars, L)
    pack_modes = [(kernels.PACK_RAW, mode, knob_ms[path].plan if path else plan, quads_l)
                  for mode, path in (("binary", None), ("class_off", "witness_class_off"),
                                     ("onehot", "witness_onehot"), ("en_off", "match_en_off"))]
    pack_modes += [(kernels.TPACK, mode, pl, tiled) for mode, pl in tiled_modes.items()]
    for k, mode, pl, x in pack_modes:
        run_k, run_p = ((kernels.pack_raw_cuda, bp.pack_plain) if k is kernels.PACK_RAW
                        else (kernels.tpack_cuda, bp.tpack_plain))
        got, want = run_k(pl, x, len_wb), run_p(pl, x, len_wb)
        torch.cuda.synchronize()
        label = f"{k.name}[{mode}, L={L}]"
        errs[label] = max_abs_err(got, want)
        log(f"[4] {label}: kernel vs plain max_abs_err={errs[label]} (tolerance 0, integer "
            f"outputs)")
        if errs[label] != 0:
            raise AssertionError(f"{label} kernel disagrees with its plain version")
        del got, want
    del quads_l

    # the table kernels on real inputs: the plain pipelines' own planes,
    # the first window of each path (configs[3]: segment 0 of 16, with the
    # backward FSM's carries from segment 1; from: the whole L)
    table_io = {"pallas_large": (chars3, lengths3), "pallas_from": (chars, lengths),
                "pallas_dict": (chars_d, lengths_d)}
    planes, t_plain_planes = {}, {}
    for path, m in tables.items():
        t0 = time.perf_counter()
        planes[path] = m.run_planes(*table_io[path], plain=True)
        torch.cuda.synchronize()
        t_plain_planes[path] = time.perf_counter() - t0
        log(f"[4] {path}: plain pipeline planes in {t_plain_planes[path]:.1f} s")

    def table_stages(path):
        """The table kernels of one call on the card, each once over the
        whole L as ``run_planes`` launches them (the scan and the FSMs in
        the form ``kernels.table_scan_form`` / ``table_fsm_form`` picks),
        against their plain versions."""
        m = tables[path]
        ch, ln = table_io[path]
        st, ids, sta, ef, fwd, bwd = planes[path]
        nd, LS, Bt = m.n_defs, m.L, ch.shape[0]
        firsts = m._firsts(Bt)

        def scan_with(fn, **kw):
            def go():
                out = torch.empty_like(st)
                fn(m.class_map, m.next_table, ch, firsts, 0, LS, out, **kw)
                return out
            return go

        def tag_with(fn):
            def go():
                outs = [torch.empty_like(st) for _ in range(3)]
                fn(st, firsts, ln, m.pairs, 0, LS, *outs)
                return tuple(outs)
            return go

        def fsm_kernel():  # both FSMs in one call
            f, b = torch.empty_like(fwd), torch.empty_like(bwd)
            kernels.table_fsms_cuda(ids, sta, ef, 0, LS, f, b)
            return f, b

        def fsm_plain():
            f, b = torch.empty_like(fwd), torch.empty_like(bwd)
            ps.fsm_plain(False, ids, sta, ef, None, None, None, 0, LS, f)
            ps.fsm_plain(True, ids, sta, ef, None, None, None, 0, LS, b)
            return f, b

        # the tag kernel's compares: a hit at list index k costs k + 1,
        # a miss the padded list length P, a masked position none
        P = m.pairs.shape[1]
        compares = 0
        pos = torch.arange(LS, device=dev)[:, None]
        for d, plist in enumerate(m.pairs.tolist()):
            prev = torch.cat([firsts[d][None], st[d, : LS - 1]])
            cmp = torch.full_like(prev, P)
            for k, (a, b, *_f) in reversed(list(enumerate(plist))):
                if a >= 0:
                    cmp = torch.where((prev == a) & (st[d, :LS] == b), k + 1, cmp)
            compares += int((cmp * (pos < ln[None, :])).sum())
        cells = nd * LS * Bt
        win = cells * 4
        return {
            "table_scan": (kernels.TABLE_SCAN,
                           scan_with(kernels.table_scan_cuda, next16=m.next_table16),
                           scan_with(ps.scan_plain),
                           bound(Bt * LS + nbytes(firsts, m.class_map, m.next_table16) + win,
                                 2 * cells)),
            "table_tag": (kernels.TABLE_TAG, tag_with(kernels.table_tag_cuda),
                          tag_with(ps.tag_plain),
                          bound(4 * win + nbytes(firsts, ln, m.pairs), 2 * compares + 4 * cells)),
            "table_fsm": (kernels.TABLE_FSM, fsm_kernel, fsm_plain,
                          bound(3 * win + 2 * LS * Bt * 4, 2 * LS * Bt * (3 * nd + 6))),
        }

    def chain_note(path, name):
        """The scan's serial chain on the card: W + C steps of the chunked
        form's speculation, or L of the serial form."""
        if name != "table_scan":
            return ""
        m = tables[path]
        C, W = kernels.table_scan_form(m.n_defs, table_io[path][0].shape[0], m.L, dev)
        n = W + C if C else m.L
        return (f", dependent-load chain of {n} steps ({'C=%d, W=%d' % (C, W) if C else 'serial'};"
                f" [10] sets it beside the probes' steps)")

    def nonzero(what, *ts):
        if not all(bool(t.any()) for t in ts):
            raise AssertionError(f"{what}: a compared plane is all zeros")

    tstages = {path: table_stages(path) for path in ("pallas_large", "pallas_from")}
    for path, stg in tstages.items():
        for name, (k, run_k, run_p, bd) in stg.items():
            want = run_p()
            got = run_k()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs[f"{name}@{path}"] = err
            log(f"[4] {name} @ {path}: kernel vs plain max_abs_err={err} (tolerance 0, "
                f"integer outputs); bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}"
                + chain_note(path, name))
            if err != 0:
                raise AssertionError(f"{name} kernel disagrees with its plain version on {path}")
            if path == "pallas_from":
                nonzero(f"{name} @ {path}", *(got if isinstance(got, tuple) else (got,)))
            del got, want
    log("[4] pallas_large has no pairs (P = 0): its tag and FSM planes are zeros, so the "
        "from: checks below hold the chunked FSM on planes that light up")

    # the table scan on the portable scan's own tables (the class map of
    # model.transition's rows) at the shapes its paths give it: serial on
    # the from: corpus, chunked on configs[3]
    portable_io = {"xla": (chars, lengths), "xla_large": (chars3, lengths3)}

    def portable_scan(path, fn, **kw):
        m = portable[path]
        ch = portable_io[path][0]
        firsts = m.first_states[:, None].expand(m.n_defs, ch.shape[0]).contiguous()

        def go():
            out = torch.empty((m.n_defs, m.L, ch.shape[0]), dtype=torch.int32, device=dev)
            fn(m.class_map, m.next_table, ch, firsts, 0, m.L, out, **kw)
            return out
        return go

    pstages = {}
    for path, m in portable.items():
        ch = portable_io[path][0]
        cells = m.n_defs * m.L * ch.shape[0]
        pstages[path] = (portable_scan(path, kernels.table_scan_cuda, next16=m.next_table16),
                         portable_scan(path, ps.scan_plain),
                         bound(ch.numel() + nbytes(m.first_states, m.class_map, m.next_table16)
                               + 4 * cells, 2 * cells))
        run_k, run_p, bd = pstages[path]
        want = run_p()
        got = run_k()
        torch.cuda.synchronize()
        errs[f"table_scan@{path}"] = err = max_abs_err(got, want)
        C, W = kernels.table_scan_form(m.n_defs, ch.shape[0], m.L, dev)
        log(f"[4] table_scan @ {path} (the portable scan's tables, "
            f"{'C=%d, W=%d' % (C, W) if C else 'serial'}): kernel vs plain max_abs_err={err} "
            f"(tolerance 0, integer outputs); bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        if err != 0:
            raise AssertionError(f"table_scan disagrees with its plain version on {path}")
        del got, want

    # the other form of the scan (serial / chunked) and of the FSMs (one
    # pass / chunked) on the same inputs; the chunked scan's repaired
    # positions against its torch twin's, at configs[3] and on a DFA that
    # never resyncs
    for path in ("pallas_large", "pallas_from"):
        m = tables[path]
        ch, ln = table_io[path]
        st, ids, sta, ef, fwd, bwd = planes[path]
        auto = kernels.table_scan_form(m.n_defs, ch.shape[0], m.L, dev)
        other = (0, 0) if auto[0] else (128, 64)
        cl = 0 if kernels.table_fsm_form(ch.shape[0], dev) else kernels.TABLE_FSM_CL
        got = torch.full_like(st, -7)
        kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(ch.shape[0]), 0, m.L,
                                got, next16=m.next_table16, form=other)
        f, b = torch.full_like(fwd, -7), torch.full_like(bwd, -7)
        kernels.table_fsms_cuda(ids, sta, ef, 0, m.L, f, b, cl=cl)
        torch.cuda.synchronize()
        errs[f"table_scan@{path}_other_form"] = e_s = max_abs_err(got, st)
        errs[f"table_fsm@{path}_other_form"] = e_f = max_abs_err((f, b), (fwd, bwd))
        log(f"[4] {path}, the other forms: table_scan {'serial' if not other[0] else other} "
            f"max_abs_err={e_s}, table_fsm {'one pass' if not cl else f'chunks of {cl}'} "
            f"max_abs_err={e_f} (tolerance 0), against the plain pipeline's planes")
        if e_s or e_f:
            raise AssertionError(f"{path}: a table kernel's other form disagrees")
        del got, f, b
    # the one-pass FSMs with their backward codes in a global scratch, the
    # form windows longer than kernels.TABLE_FSM_SMEM_LS take
    st, ids, sta, ef, fwd, bwd = planes["pallas_from"]
    f, b = torch.full_like(fwd, -7), torch.full_like(bwd, -7)
    smem_ls, kernels.TABLE_FSM_SMEM_LS = kernels.TABLE_FSM_SMEM_LS, 0
    try:
        kernels.table_fsms_cuda(ids, sta, ef, 0, tables["pallas_from"].L, f, b, cl=0)
    finally:
        kernels.TABLE_FSM_SMEM_LS = smem_ls
    torch.cuda.synchronize()
    errs["table_fsm@pallas_from_global_codes"] = e_g = max_abs_err((f, b), (fwd, bwd))
    log(f"[4] pallas_from, table_fsm one pass with its codes in global memory: fwd and bwd "
        f"vs the plain pipeline's planes max_abs_err={e_g} (tolerance 0)")
    if e_g:
        raise AssertionError("table_fsm with global codes disagrees")
    del f, b

    def repaired_vs_twin(what, m, ch, want):
        """The chunked scan once, its repaired positions beside the twin's."""
        C, W = kernels.table_scan_form(m.n_defs, ch.shape[0], m.L, dev)
        if not C:
            raise AssertionError(f"{what}: the scan no longer takes its chunked form")
        firsts = m._firsts(ch.shape[0])
        got = torch.full_like(want, -7)
        before = kernels.table_scan_repaired(dev)
        kernels.table_scan_cuda(m.class_map, m.next_table, ch, firsts, 0, m.L, got,
                                next16=m.next_table16)
        n_k = kernels.table_scan_repaired(dev) - before
        twin = torch.full_like(want, -7)
        n_t = ps.scan_chunks_plain(m.class_map, m.next_table, ch, firsts, 0, m.L, C, W, twin)
        torch.cuda.synchronize()
        err = max(max_abs_err(got, want), max_abs_err(twin, want))
        log(f"[4] table_scan @ {what} (C={C}, W={W}): kernel and twin vs plain max_abs_err={err} "
            f"(tolerance 0); repaired positions: kernel {n_k}, twin {n_t}, of "
            f"{ch.shape[0] * m.L}")
        if err or n_k != n_t:
            raise AssertionError(f"{what}: the chunked scan disagrees with its twin or plain")
        return err, n_k, (C, W)

    errs["table_scan@pallas_large_twin"], rec["repaired_configs3_check"], _cw = repaired_vs_twin(
        "pallas_large", m3, chars3, planes["pallas_large"][0])
    mp, chars_p = permutation_dfa(h2r)
    chars_p = torch.from_numpy(chars_p).to(dev)
    lengths_p = torch.full((B3,), L3, dtype=torch.int32, device=dev)
    planes_p = mp.run_planes(chars_p, lengths_p, plain=True)
    err, n_perm, (Cp, Wp) = repaired_vs_twin("permutation", mp, chars_p, planes_p[0])
    errs["table_scan@permutation"] = err
    if n_perm < 0.99 * B3 * (L3 - Wp - Cp):
        raise AssertionError(f"permutation: only {n_perm} positions repaired")
    kernels.reset_launch_counts()
    out_p = mp(chars_p, lengths_p)
    torch.cuda.synchronize()
    launches_p = counts(kernels)
    want_p = {k.name: 0 for k in kernels.KERNELS}
    want_p.update({k.name: v for k, v in kernels.table_path_launches(mp, B3).items()})
    if launches_p != want_p:
        raise AssertionError(f"permutation: launch counts {launches_p}, expected {want_p}")
    assert_same("permutation", out_p, mp.finish(chars_p, lengths_p, *planes_p))
    torch.cuda.synchronize()
    rec["repaired_permutation"] = n_perm
    log(f"[4] permutation: the matcher once launches {launches_p} and equals its plain "
        f"pipeline on every field; {n_perm} of {B3 * L3} positions repaired (the speculative "
        f"chunks: every guess fails)")
    perm_run = (mp, chars_p)
    del out_p, planes_p

    # the flat kernel (monolithic mode) on the whole dictionary corpus: its
    # plain version's output is the plain pipeline's planes; the kernel
    # with its table in shared memory (the matcher's choice) and read from
    # global memory
    def flat_with(fn, **kw):
        def go():
            outs = [torch.empty_like(t) for t in planes["pallas_dict"]]
            fn(md.class_map, md.flat_table, md.first_states, chars_d, lengths_d, *outs, **kw)
            return tuple(outs)
        return go

    nd_d = md.n_defs
    # bytes: chars, lengths and tables in, the six planes out; operations
    # per position and string: per def the row offset, the entry's four
    # fields, masking and sums (12), the forward FSM and the parked column
    # (10), the backward FSM (8)
    flat_stage = (kernels.TABLE_FLAT, flat_with(kernels.table_flat_cuda), flat_with(ps.flat_plain),
                  bound(nbytes(chars_d, lengths_d, md.class_map, md.flat_table, md.first_states,
                               *planes["pallas_dict"]), L * B * (12 * nd_d + 18)))
    flat_global = flat_with(kernels.table_flat_cuda, table_in_smem=False)
    got, got_g = flat_stage[1](), flat_global()
    torch.cuda.synchronize()
    errs["table_flat"] = max(max_abs_err(got, planes["pallas_dict"]),
                             max_abs_err(got_g, planes["pallas_dict"]))
    bd = flat_stage[3]
    log(f"[4] table_flat @ pallas_dict, table in shared memory and in global memory: kernel "
        f"vs plain max_abs_err={errs['table_flat']} (tolerance 0, integer outputs); bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; table {tuple(md.flat_table.shape)} in "
        f"shared memory: "
        f"{kernels.flat_smem_bytes(*md.flat_table.shape, kernels._smem_optin(dev))} B")
    if errs["table_flat"] != 0:
        raise AssertionError("table_flat kernel disagrees with its plain version")
    nonzero("table_flat @ pallas_dict", *got[1:])
    del got, got_g

    # the from: corpus at B=4096: table_fsm cuts each string's window into
    # chunks there (the instance configs[3] runs), and a middle window
    # [WIN0, WIN0 + WIN_LS) takes carries on both sides; every kernel
    # against its plain version on that window and against the plain
    # pipeline's planes over all of L, on planes that are not all zeros
    nb = B_LATENCY
    ch4, ln4 = chars[:nb], lengths[:nb]
    n_chunks = kernels.table_fsm_form(nb, dev)
    if not n_chunks:
        raise AssertionError(f"B={nb}: table_fsm takes its one-pass form; the check needs chunks")
    planes4 = mf.run_planes(ch4, ln4, plain=True)
    st4, ids4, sta4, ef4, fwd4, bwd4 = planes4
    q0, q1 = WIN0, WIN0 + WIN_LS
    win = slice(q0, q1)

    def fresh(t):
        return torch.full_like(t, -7)

    carry_f = (fwd4[q0 - 1], ids4[:, q0 - 1], ef4[:, q0 - 1])
    carry_b = (bwd4[q1], ids4[:, q1], sta4[:, q1])
    nonzero(f"B={nb} window carries", carry_f[0], carry_b[0])
    for name, fn, outs, whole in (
        ("table_scan", lambda f, o: f(mf.class_map, mf.next_table, ch4, st4[:, q0 - 1], q0,
                                      WIN_LS, *o), [st4], [st4]),
        ("table_tag", lambda f, o: f(st4, st4[:, q0 - 1], ln4, mf.pairs, q0, WIN_LS, *o),
         [ids4, sta4, ef4], [ids4, sta4, ef4]),
        ("table_fsm", None, [fwd4, bwd4], [fwd4, bwd4]),
    ):
        got, want = [fresh(t) for t in outs], [fresh(t) for t in outs]
        if name == "table_fsm":
            kernels.table_fsm_cuda(False, ids4, sta4, ef4, *carry_f, q0, WIN_LS, got[0])
            kernels.table_fsm_cuda(True, ids4, sta4, ef4, *carry_b, q0, WIN_LS, got[1])
            ps.fsm_plain(False, ids4, sta4, ef4, *carry_f, q0, WIN_LS, want[0])
            ps.fsm_plain(True, ids4, sta4, ef4, *carry_b, q0, WIN_LS, want[1])
        else:
            fn(getattr(kernels, f"{name}_cuda"), got)
            fn(getattr(ps, f"{name.split('_')[1]}_plain"), want)
        torch.cuda.synchronize()
        got = tuple(g[..., win, :] for g in got)
        want = tuple(w[..., win, :] for w in want)
        err = max(max_abs_err(got, want),
                  max_abs_err(got, tuple(t[..., win, :] for t in whole)))
        errs[f"{name}@from_b{nb}_window"] = err
        log(f"[4] {name} @ from: B={nb}, window [{q0}, {q1}) with carries: kernel vs plain "
            f"max_abs_err={err} (tolerance 0), also vs the plain pipeline's planes"
            + (f"; chunks of {n_chunks} positions" if name == "table_fsm" else ""))
        if err != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain version at B={nb}")
        nonzero(f"{name} @ B={nb} window", *got)
        del got, want

    # the models past the table kernels' staging: a def of 7511 pairs (the
    # tag kernel stages 4096 in shared memory and searches the rest in
    # global memory) and nine monolithic defs (the flat kernel scans them
    # in two groups); each kernel against its plain version, then the
    # matcher once with its launches, equal to its plain pipeline
    for name, m, ch, ln in beyond_staging(h2r):
        st, ids, sta, ef, fwd, bwd = m.run_planes(ch, ln, plain=True)
        if m.mode == "split":
            k = kernels.TABLE_TAG
            got, want = [torch.full_like(st, -7) for _ in range(3)], (ids, sta, ef)
            kernels.table_tag_cuda(st, m._firsts(ch.shape[0]), ln, m.pairs, 0, m.L, *got)
            # the scan and both FSMs in both their forms
            for form, cl in (((0, 0), 0), ((16, 8), kernels.TABLE_FSM_CL)):
                s_k = torch.full_like(st, -7)
                kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(ch.shape[0]), 0,
                                        m.L, s_k, next16=m.next_table16, form=form)
                f_k, b_k = torch.full_like(fwd, -7), torch.full_like(bwd, -7)
                kernels.table_fsms_cuda(ids, sta, ef, 0, m.L, f_k, b_k, cl=cl)
                torch.cuda.synchronize()
                e_s = errs[f"table_scan@{name}_{form}"] = max_abs_err(s_k, st)
                e_f = errs[f"table_fsm@{name}_cl{cl}"] = max_abs_err((f_k, b_k), (fwd, bwd))
                log(f"[4] table_scan {form} and table_fsm cl={cl} @ {name}: kernel vs plain "
                    f"max_abs_err={e_s}, {e_f} (tolerance 0)")
                if e_s or e_f:
                    raise AssertionError(f"table_scan or table_fsm disagrees on {name}")
                nonzero(f"table_fsm @ {name}", f_k, b_k)
                del s_k, f_k, b_k
        else:
            k = kernels.TABLE_FLAT
            want = (st, ids, sta, ef, fwd, bwd)
            got = [torch.full_like(t, -7) for t in want]
            kernels.table_flat_cuda(m.class_map, m.flat_table, m.first_states, ch, ln, *got)
        torch.cuda.synchronize()
        err = errs[f"{k.name}@{name}"] = max_abs_err(tuple(got), tuple(want))
        if err != 0:
            raise AssertionError(f"{k.name} disagrees with its plain version on {name}")
        nonzero(f"{k.name} @ {name}", *got[-3:])
        kernels.reset_launch_counts()
        out = m(ch, ln)
        torch.cuda.synchronize()
        launches = {kk.name: kk.launches for kk in kernels.KERNELS}
        expected = {kk.name: 0 for kk in kernels.KERNELS}
        expected.update({kk.name: v for kk, v in
                         kernels.table_path_launches(m, ch.shape[0]).items()})
        if launches != expected:
            raise AssertionError(f"{name}: launch counts {launches}, expected {expected}")
        assert_same(name, out, m.finish(ch, ln, st, ids, sta, ef, fwd, bwd))
        nonzero(f"{name} mask", out.mask)
        torch.cuda.synchronize()
        log(f"[4] {k.name} @ {name} ({m.mode}, {m.n_defs} defs, {m.pairs.shape[1]} pairs a "
            f"def at most, B={ch.shape[0]} x L={m.L}): kernel vs plain max_abs_err={err} "
            f"(tolerance 0); the matcher once launches {launches} and equals its plain "
            f"pipeline on every field")
        del st, ids, sta, ef, fwd, bwd, got, want, out

    # [5] each path once through the matcher, with launch counts
    rng = np.random.default_rng(1)
    idx = np.sort(rng.choice(B, size=ORACLE_N, replace=False))
    idx_t = torch.from_numpy(idx).to(dev)
    path_inputs = {"witness": inputs[L], "match": inputs[L], "full": inputs[L],
                   "L1000": inputs[L_UNPADDED], "tiled_witness": (tiled, lengths),
                   "tiled_match": (tiled, lengths)}
    outs, path_launches = {}, {}
    for path, m in matchers.items():
        ch, ln = path_inputs[path]
        kernels.reset_launch_counts()
        out = m(ch, ln)
        torch.cuda.synchronize()
        launches = counts(kernels)
        expected = {k.name: 0 for k in kernels.KERNELS}
        expected.update({k.name: n for k, n in kernels.path_launches(m.plan).items()})
        log(f"[5] {path}: launches {launches}")
        if launches != expected:
            raise AssertionError(f"{path}: launch counts {launches}, expected {expected}")
        assert_same(path, out, bp.run(m.plan, m.tables(), ch, ln, plain=True))
        torch.cuda.synchronize()
        outs[path], path_launches[path] = out, launches
        log(f"[5] {path}: equals the plain pipeline on all {len(as_dict(out))} outputs")
    for path, m in tables.items():
        ch, ln = table_io[path]
        before = kernels.table_scan_repaired(dev)
        kernels.reset_launch_counts()
        out = m(ch, ln)
        torch.cuda.synchronize()
        launches = counts(kernels)
        repaired = kernels.table_scan_repaired(dev) - before
        expected = {k.name: 0 for k in kernels.KERNELS}
        expected.update({k.name: v for k, v in
                         kernels.table_path_launches(m, ch.shape[0]).items()})
        log(f"[5] {path}: launches {launches}, {sum(launches.values())} custom launches a call; "
            f"the chunked scan repaired {repaired} positions")
        if launches != expected:
            raise AssertionError(f"{path}: launch counts {launches}, expected {expected}")
        assert_same(path, out, m.finish(ch, ln, *planes[path]))
        torch.cuda.synchronize()
        outs[path], path_launches[path] = out, launches
        rec.setdefault("repaired", {})[path] = repaired
        log(f"[5] {path}: equals the plain pipeline on all {len(as_dict(out))} fields, "
            f"dtypes included ({m.mode}; one pass over L on the card, the plain pipeline "
            f"{m.L // m.window} windows of {m.window})")
    # the portable scan's paths: the table scan alone (serial at the from:
    # bench shape, chunked on configs[3]) and torch ops
    t_plain_portable = {}
    for path, m in portable.items():
        ch, ln = portable_io[path]
        kernels.reset_launch_counts()
        out = m(ch, ln)
        torch.cuda.synchronize()
        launches = counts(kernels)
        expected = {k.name: 0 for k in kernels.KERNELS}
        expected.update({k.name: v for k, v in kernels.scan_path_launches(m, ch.shape[0]).items()})
        log(f"[5] {path}: launches {launches}")
        if launches != expected or launches["table_scan"] != (2 if path == "xla_large" else 1):
            raise AssertionError(f"{path}: launch counts {launches}, expected {expected}")
        t0 = time.perf_counter()
        want = m.run(ch, ln, plain=True)
        torch.cuda.synchronize()
        t_plain_portable[path] = time.perf_counter() - t0
        assert_same(path, out, want)
        outs[path], path_launches[path] = out, launches
        log(f"[5] {path}: equals its plain pipeline (plain scan on the card, "
            f"{t_plain_portable[path]:.1f} s) on all {len(as_dict(out))} fields, dtypes included")
        del want
    for ref_name, ref in (("pallas_from", outs["pallas_from"]),
                          ("BitplaneMatcher(compact=False)", full32(chars, lengths))):
        assert_same(f"xla vs {ref_name}", outs["xla"], ref)
        torch.cuda.synchronize()
        log(f"[5] xla equals {ref_name} on every field, dtypes included")
    # the C++ host oracle on the whole batch of each portable path
    if not native.available():
        raise AssertionError("the native oracle (g++) is not available on this host")
    rec["native_oracle_s"] = {}
    for path, (c_np, l_np) in (("xla", corpora[L]), ("xla_large", (chars3_np, lengths3_np))):
        t0 = time.perf_counter()
        nat = native.match_substrs_native(portable[path].model, c_np, l_np)
        rec["native_oracle_s"][path] = t_nat = time.perf_counter() - t0
        got = as_dict(outs[path])
        for key, v in nat.items():
            g = got[key].cpu().numpy()
            if g.dtype != v.dtype or not np.array_equal(g, v):
                raise AssertionError(f"{path}[{key}] differs from the native oracle")
        log(f"[5] {path}: all {c_np.shape[0]} strings equal the native C++ oracle on its "
            f"{len(nat)} columns; oracle host time {t_nat:.3f} s on {native.num_threads()} "
            f"threads")
        del nat, got
    for path, want in (("witness", "tiled_witness"), ("match", "tiled_match")):
        assert_same(f"{want} vs {path}", outs[want], outs[path])
        log(f"[5] {want} equals the {path} path on all {len(outs[path])} keys, dtypes included")
    for path, ref, (ch, ln) in (("pallas_from", full32, (chars, lengths)),
                                ("pallas_dict", dict32, (chars_d, lengths_d))):
        assert_same(f"{path} vs BitplaneMatcher(compact=False)", outs[path], ref(ch, ln))
        torch.cuda.synchronize()
        log(f"[5] {path} equals BitplaneMatcher(model, compact=False) on every field, "
            "dtypes included")
    od = outs["pallas_dict"]
    n_words = int((od.match_ok & (od.all_substr_ids != 0).any(-1)).sum())
    if n_words < B // 4:
        raise AssertionError(f"pallas_dict: only {n_words} of {B} strings match with a word")
    assert_same("pallas_dict vs its split mode", dict_split(chars_d, lengths_d), od)
    torch.cuda.synchronize()
    log(f"[5] pallas_dict: {n_words} of {B} strings match and extract a word; equals "
        f"PallasMatcher(dict40, max_pairs=4096) (split mode) on every field")
    del od
    # the B=4096 call the latency row times: the chunked FSM instance
    kernels.reset_launch_counts()
    out4 = mf(ch4, ln4)
    torch.cuda.synchronize()
    launches4 = counts(kernels)
    want4 = {k.name: 0 for k in kernels.KERNELS}
    want4.update({k.name: v for k, v in kernels.table_path_launches(mf, nb).items()})
    if launches4 != want4:
        raise AssertionError(f"pallas_from at B={nb}: launch counts {launches4}, expected "
                             f"{want4}")
    assert_same(f"pallas_from at B={nb}", out4, mf.finish(ch4, ln4, *planes4))
    nonzero(f"pallas_from at B={nb}", out4.mask, out4.all_substr_ids)
    torch.cuda.synchronize()
    log(f"[5] pallas_from at B={nb} (FSM chunks of {n_chunks} positions) equals its plain "
        f"pipeline on every field, dtypes included; launches {launches4}")
    del out4, planes4, st4, ids4, sta4, ef4, fwd4, bwd4, carry_f, carry_b, whole

    # the oracle on a 256-string subset of each path
    checks = {
        "witness": ("states", "all_substr_ids", "masked_characters", "mask", "match_ok"),
        "match": ("accepted", "has_dead", "match_ok"),
        "full": tuple(h2r.RegexResult.field_names()),
        "L1000": ("states", "all_substr_ids", "masked_characters", "mask", "match_ok"),
        "tiled_witness": ("states", "all_substr_ids", "masked_characters", "mask", "match_ok"),
        "tiled_match": ("accepted", "has_dead", "match_ok"),
    }
    def oracle(o_model, c_np, l_np, sub):
        return {int(i): match_substrs(o_model.regex_defs, bytes(c_np[i, : l_np[i]]),
                                      c_np.shape[1]) for i in sub}

    oracle_rows = oracle(model, *corpora[L], idx)  # every from: path at L shares them
    for path, keys in checks.items():
        rows = oracle(model_u, *corpora[L_UNPADDED], idx) if path == "L1000" else oracle_rows
        oracle_equal(path, outs[path], keys, rows, idx)
        log(f"[5] {path}: {ORACLE_N} strings equal the numpy oracle on {list(keys)}")
    idx3 = np.sort(rng.choice(B3, size=ORACLE_N3, replace=False))
    rows3 = oracle(model3, chars3_np, lengths3_np, idx3)
    for path, rows, sub in (
        ("pallas_from", oracle_rows, idx),
        ("pallas_large", rows3, idx3),
        ("pallas_dict", oracle(model_d, *dict_np, idx), idx),
        ("xla", oracle_rows, idx),
        ("xla_large", rows3, idx3),
    ):
        oracle_equal(path, outs[path], checks["full"], rows, sub)
        log(f"[5] {path}: {len(sub)} strings equal the numpy oracle on every field")
    n_ok = {p: int(as_dict(o)["match_ok"].sum().item()) for p, o in outs.items()}
    rec["match_ok"] = n_ok
    log(f"[5] match_ok per path {n_ok} (of {B}; pallas_large and xla_large of {B3}); full states "
        f"{tuple(outs['full'].states.shape)} {outs['full'].states.dtype}")

    # extraction serving: runs on the card == runs on the plain output ==
    # the oracle's extracted substrings
    def serve(m, ch, ln):
        res = m(ch, ln)
        runs = h2r.extract_runs(res.all_substr_ids, res.masked_characters, **EXTRACT)
        runs["match_ok"] = res.match_ok
        return runs

    full_m = matchers["full"]
    runs = serve(full_m, chars, lengths)
    ref_full = bp.run(full_m.plan, full_m.tables(), chars, lengths, plain=True)
    runs_ref = h2r.extract_runs(ref_full.all_substr_ids, ref_full.masked_characters, **EXTRACT)
    runs_ref["match_ok"] = ref_full.match_ok
    assert_same("extract_runs", runs, runs_ref)
    del ref_full, runs_ref
    host_runs = {k: v[idx_t].cpu() for k, v in runs.items()}
    n_cmp = 0
    for r, i in enumerate(idx):
        want = extract_substrings(oracle_rows[int(i)])
        if len(want) <= EXTRACT["max_runs"] and all(len(t) <= EXTRACT["max_len"] for _o, t, _i in want):
            if h2r.runs_to_python(host_runs, r) != want:
                raise AssertionError(f"string {i}: extracted runs differ from the oracle")
            n_cmp += 1
        if int(host_runs["n_runs"][r]) != len(want):
            raise AssertionError(f"string {i}: n_runs differs from the oracle")
    if n_cmp < ORACLE_N // 2:
        raise AssertionError(f"only {n_cmp} strings fit max_runs/max_len")
    log(f"[5] extraction serving: runs equal the plain pipeline's; {n_cmp} of "
        f"{ORACLE_N} strings equal the oracle's extract_substrings (the rest "
        f"exceed max_runs/max_len; n_runs equal on all)")
    twins = {p: outs[p] for p in ("witness", "match", "full")}  # the knob paths' references
    del outs, runs, host_runs

    # cli_scan: the corpus-scan entry point in process, both layouts, each
    # run with the launch counts reset just before it; the counters of the
    # two layouts are equal and count the match path's verdicts on the same
    # packed lines, batch by batch
    c_np, l_np = bench_corpus(N_CLI, L)  # its first B strings are corpora[L]'s
    data = b"".join(bytes(c_np[i, : l_np[i]]) for i in range(N_CLI))
    work = kernels.build_root() / "cli_scan"
    work.mkdir(parents=True, exist_ok=True)
    corpus_file, model_file = work / "corpus.txt", work / "from.npz"
    corpus_file.write_bytes(data)
    model.save(str(model_file))
    p_chars, p_lens, _trunc = pack_lines(data, L, keep_newline=True)
    want_ok, n_batches = 0, 0
    for bc, bl, nv in batch_iterator(p_chars, p_lens, B):
        want_ok += int(matchers["match"](bc, bl)["match_ok"][:nv].sum())
        n_batches += 1
    cli_runs = {}
    for layout in ("bl", "tiled", "bl", "tiled"):
        kernels.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["scan", "--model", str(model_file), "--batch", str(B),
                           "--keep-newline", "--input-layout", layout, str(corpus_file)])
        torch.cuda.synchronize()
        launches = counts(kernels)
        if rc != 0:
            raise AssertionError(f"cli scan --input-layout {layout} exited {rc}")
        counters = json.loads(buf.getvalue().strip().splitlines()[-1])
        plan_l = matchers["tiled_match" if layout == "tiled" else "match"].plan
        expected = {k.name: 0 for k in kernels.KERNELS}
        expected.update({k.name: n * n_batches for k, n in kernels.path_launches(plan_l).items()})
        log(f"[5] cli_scan {layout}: {json.dumps(counters)}; launches {launches}")
        if launches != expected:
            raise AssertionError(f"cli_scan {layout}: launches {launches}, expected {expected}")
        if (counters["strings"], counters["matched"], counters["batches"]) != (
                2 * N_CLI, want_ok, n_batches) or want_ok != N_CLI:
            raise AssertionError(f"cli_scan {layout}: counters {counters}; the match path "
                                 f"counts {want_ok} of {2 * N_CLI} in {n_batches} batches")
        cli_runs.setdefault(layout, []).append(counters)
    keys = ("batches", "strings", "bytes_scanned", "matched", "failed", "dead")
    if any(r[k] != cli_runs["bl"][0][k] for rs in cli_runs.values() for r in rs for k in keys):
        raise AssertionError(f"cli_scan: the layouts' counters differ: {cli_runs}")
    rec["cli_scan"] = cli_runs
    log(f"[5] cli_scan: both layouts count {want_ok} matches of {2 * N_CLI} lines in "
        f"{n_batches} batches, as the match path does; launches per batch as its paths")
    # device_expand: the same file through ScanJob with each chunk's raw
    # bytes uploaded once and the rows gathered on the card, in turns with
    # the host-packed job (host, device, device, host) for each layout
    dx_runs = {}
    for layout in ("bl", "tiled"):
        m = matchers["tiled_match" if layout == "tiled" else "match"]
        for dx in (False, True, True, False):
            kernels.reset_launch_counts()
            job = h2r.ScanJob(m, [str(corpus_file)], batch_size=B, keep_newline=True,
                              device_expand=dx)
            counters = json.loads(job.run().to_json())
            torch.cuda.synchronize()
            launches = counts(kernels)
            expected = {k.name: 0 for k in kernels.KERNELS}
            expected.update({k.name: n * n_batches
                             for k, n in kernels.path_launches(m.plan).items()})
            what = f"device_expand {layout} ({'device' if dx else 'host'}-packed)"
            if launches != expected:
                raise AssertionError(f"{what}: launches {launches}, expected {expected}")
            if any(counters[k] != cli_runs["bl"][0][k] for k in keys):
                raise AssertionError(f"{what}: counters {counters} differ from cli_scan's")
            dx_runs.setdefault(f"{layout}_{'device' if dx else 'host'}", []).append(counters)
    rec["device_expand"] = dx_runs
    log(f"[5] device_expand: ScanJob(device_expand=True) counts what the host-packed job and "
        f"cli_scan count ({want_ok} of {2 * N_CLI} in {n_batches} batches) in both layouts, "
        f"with the match paths' launches per batch")
    del data, p_chars, p_lens

    # [6] timings
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    kern_rows, times = [], {}
    path_of = {"qpack": "witness", "scan": "witness", "post": "witness",
               "fb_only": "match", "post_planes": "full", "pack_raw": "L1000",
               "tpack": "tiled_witness", "post_tiled": "tiled_witness"}
    for name, (k, run_k, run_p) in stages.items():
        tk = time_ms(run_k, flush, device_only=True)
        tp = time_ms(run_p, flush, device_only=True)
        times[name] = {"kernel": tk, "plain": tp}
        log(f"[6] {name}: kernel {fmt(tk)}, plain {fmt(tp)}")
        kern_rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": path_launches[path_of[name]][k.name],
            "max_abs_err": errs[name], "ms": tk["median"], "plain_ms": tp["median"],
            "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
            "library_ms": None,
        })
    del quads_u
    # the table kernels at both configurations, each as one call launches
    # it over the whole L (the fsm row is both FSMs); the line's entry is
    # configs[3]'s, with the largest error of any of the kernel's checks;
    # from:'s rides under "configs"
    table_rows = {}
    for path, stg in tstages.items():
        for name, (k, run_k, run_p, bd) in stg.items():
            tk = time_ms(run_k, flush, device_only=True)
            tp = time_ms(run_p, flush, device_only=True, warmup=PLAIN_WARMUP,
                         iters=PLAIN_ITERS)
            times[f"{name}@{path}"] = {"kernel": tk, "plain": tp, **bd}
            log(f"[6] {name} @ {path}: kernel {fmt(tk)}, plain {fmt(tp)} over "
                f"{tp['runs']} runs; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}"
                + chain_note(path, name))
            row = {"launches": path_launches[path][k.name], "max_abs_err": errs[f"{name}@{path}"],
                   "ms": tk["median"], "plain_ms": tp["median"], "bound_ms": bd["bound_ms"],
                   "bound_by": bd["bound_by"], "library_ms": None}
            if path == "pallas_large":
                worst = max(v for key, v in errs.items() if key.split("@")[0] == name)
                table_rows[name] = {"name": k.name, "route": "cuda", "source": k.source,
                                    "replaces": k.replaces, **row, "max_abs_err": worst,
                                    "configs": {}}
            else:
                table_rows[name]["configs"][path] = row
    # the table scan as the portable scan's paths launch it (its tables)
    for path, (run_k, run_p, bd) in pstages.items():
        tk = time_ms(run_k, flush, device_only=True)
        tp = time_ms(run_p, flush, device_only=True, warmup=PLAIN_WARMUP, iters=PLAIN_ITERS)
        times[f"table_scan@{path}"] = {"kernel": tk, "plain": tp, **bd}
        log(f"[6] table_scan @ {path}: kernel {fmt(tk)}, plain {fmt(tp)} over {tp['runs']} "
            f"runs; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; card {card}")
        table_rows["table_scan"]["configs"][path] = {
            "launches": path_launches[path]["table_scan"],
            "max_abs_err": errs[f"table_scan@{path}"], "ms": tk["median"],
            "plain_ms": tp["median"], "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "library_ms": None}
    del pstages
    kern_rows += list(table_rows.values())
    k, run_k, run_p, bd = flat_stage
    tk = time_ms(run_k, flush, device_only=True)
    tp = time_ms(run_p, flush, device_only=True, warmup=PLAIN_WARMUP, iters=PLAIN_ITERS)
    tg = time_ms(flat_global, flush, device_only=True)
    times["table_flat@pallas_dict"] = {"kernel": tk, "plain": tp, **bd}
    times["table_flat@pallas_dict_global_table"] = {"kernel": tg}
    log(f"[6] table_flat @ pallas_dict: kernel {fmt(tk)} (table read from global memory: "
        f"{fmt(tg)}), plain {fmt(tp)} over {tp['runs']} runs; bound {bd['bound_ms']:.4f} ms "
        f"by {bd['bound_by']}")
    kern_rows.append({"name": k.name, "route": "cuda", "source": k.source,
                      "replaces": k.replaces, "launches": path_launches["pallas_dict"][k.name],
                      "max_abs_err": errs["table_flat"], "ms": tk["median"],
                      "plain_ms": tp["median"], "bound_ms": bd["bound_ms"],
                      "bound_by": bd["bound_by"], "library_ms": None})
    # the chain measured: configs[3]'s first 4096 positions for one string
    # (the serial form: one thread, table staging included)
    f1 = m3._firsts(1)
    one = torch.empty((m3.n_defs, m3.L, 1), dtype=torch.int32, device=dev)
    t1 = time_ms(lambda: kernels.table_scan_cuda(m3.class_map, m3.next_table, chars3[:1], f1,
                                                 0, m3.segment, one, next16=m3.next_table16,
                                                 form=(0, 0)), flush, device_only=True)
    times["table_scan_one_string@pallas_large"] = {"kernel": t1}
    log(f"[6] table_scan @ pallas_large, one string over {m3.segment} positions (serial form): "
        f"{fmt(t1)} (64 strings over all {m3.L}: "
        f"{times['table_scan@pallas_large']['kernel']['median']:.4f} ms)")
    # the worst case of the chunked scan: every speculative chunk repaired
    mp, chars_p = perm_run
    fp = mp._firsts(B3)
    outp = torch.empty((1, L3, B3), dtype=torch.int32, device=dev)
    tperm = time_ms(lambda: kernels.table_scan_cuda(mp.class_map, mp.next_table, chars_p, fp, 0,
                                                    L3, outp, next16=mp.next_table16),
                    flush, device_only=True)
    times["table_scan@permutation"] = {"kernel": tperm}
    log(f"[6] table_scan @ permutation (every speculative chunk repaired): {fmt(tperm)}; "
        f"card {card}")
    del outp

    e2e_paths = {
        "witness": (lambda: matchers["witness"](chars, lengths), "witness", inputs[L]),
        "match": (lambda: matchers["match"](chars, lengths), "match", inputs[L]),
        "full": (lambda: matchers["full"](chars, lengths), "full", inputs[L]),
        "extract_serving": (lambda: serve(full_m, chars, lengths), "full", inputs[L]),
        "L1000": (lambda: matchers["L1000"](chars_u, lengths_u), "L1000", inputs[L_UNPADDED]),
        "tiled_witness": (lambda: matchers["tiled_witness"](tiled, lengths), "tiled_witness",
                          (tiled, lengths)),
        "tiled_match": (lambda: matchers["tiled_match"](tiled, lengths), "tiled_match",
                        (tiled, lengths)),
    }
    for path, m in tables.items():
        ch, ln = table_io[path]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time_ms(lambda: m(ch, ln), flush, device_only=False)
        peak = torch.cuda.max_memory_allocated()
        enq = host_ms(lambda: m(ch, ln))
        tp = time_ms(lambda: m.run(ch, ln, plain=True), flush, device_only=False,
                     warmup=PLAIN_WARMUP, iters=PLAIN_ITERS)
        gbs = ch.numel() / (t["median"] * 1e-3) / 1e9
        times[f"end_to_end_{path}"] = {"kernel": t, "plain": tp, "peak_bytes": peak,
                                       "input_gb_per_s": gbs, "host_enqueue": enq}
        if path == "pallas_dict":  # beside its split-mode equivalent
            ts = time_ms(lambda: dict_split(ch, ln), flush, device_only=False)
            times["end_to_end_pallas_dict_split"] = {"kernel": ts}
            log(f"[6] end to end pallas_dict in split mode (max_pairs=4096): {fmt(ts)}; "
                f"card {card}")
        log(f"[6] end to end {path}: {fmt(t)}, {gbs:.3f} GB/s of input, host enqueue "
            f"{enq['median']:.4f} ms; plain pipeline {fmt(tp)} over {tp['runs']} runs; "
            f"peak memory {peak / 2**20:.1f} MiB; card {card}")
    # the portable scan's walls, each beside PallasMatcher's on the same
    # inputs (taken right after it), with its plain pipeline's
    for path, m, pm, (ch, ln) in (
        ("xla", xla, mf, (chars, lengths)),
        (f"xla_b{B_LATENCY}", xla, mf, (chars[:B_LATENCY], lengths[:B_LATENCY])),
        ("xla_large", xla_large, m3, (chars3, lengths3)),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time_ms(lambda: m(ch, ln), flush, device_only=False)
        peak = torch.cuda.max_memory_allocated()
        tpm = time_ms(lambda: pm(ch, ln), flush, device_only=False)
        enq = host_ms(lambda: m(ch, ln))
        tp = time_ms(lambda: m.run(ch, ln, plain=True), flush, device_only=False,
                     warmup=PLAIN_WARMUP, iters=PLAIN_ITERS)
        gbs = ch.numel() / (t["median"] * 1e-3) / 1e9
        times[f"end_to_end_{path}"] = {"kernel": t, "plain": tp, "pallas": tpm,
                                       "peak_bytes": peak, "input_gb_per_s": gbs,
                                       "host_enqueue": enq}
        log(f"[6] end to end {path} (B={ch.shape[0]}): {fmt(t)}, {gbs:.3f} GB/s of input, host "
            f"enqueue {enq['median']:.4f} ms; PallasMatcher on the same inputs {fmt(tpm)}; "
            f"plain pipeline {fmt(tp)} over {tp['runs']} runs; peak memory "
            f"{peak / 2**20:.1f} MiB; card {card}")
    for path, (fn, mk, (ch, ln)) in e2e_paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time_ms(fn, flush, device_only=False)
        peak = torch.cuda.max_memory_allocated()
        m = matchers[mk]
        if path != "extract_serving":
            tp = time_ms(lambda: bp.run(m.plan, m.tables(), ch, ln, plain=True), flush,
                         device_only=False, warmup=PLAIN_WARMUP, iters=PLAIN_ITERS)
        else:
            tp = None
        gbs = B * (L_UNPADDED if path == "L1000" else L) / (t["median"] * 1e-3) / 1e9
        times[f"end_to_end_{path}"] = {"kernel": t, "plain": tp, "peak_bytes": peak,
                                       "input_gb_per_s": gbs}
        plain_txt = (f"plain pipeline {fmt(tp)} over {tp['runs']} runs" if tp else
                     "plain: see full")
        log(f"[6] end to end {path}: {fmt(t)}, {gbs:.3f} GB/s of input; {plain_txt}; "
            f"peak memory {peak / 2**20:.1f} MiB; card {card}")
    # ROADMAP A8's question: the tiled and [B, L] walls at both batch sizes,
    # with the host's tile_corpus time per batch beside them
    tiled4_np = h2r.tile_corpus(corpora[L][0][:B_LATENCY], pt.L_pad)
    tiled4 = torch.from_numpy(tiled4_np).to(dev)
    for nb_, src in ((B, corpora[L][0]), (B_LATENCY, corpora[L][0][:B_LATENCY])):
        th = host_ms(lambda: h2r.tile_corpus(src, pt.L_pad), iters=5)
        times[f"tile_corpus_host_b{nb_}"] = th
        log(f"[6] host tile_corpus at B={nb_}: {th['median']:.4f} ms per batch (median of "
            f"5, native packer: {native.available()}, {os.cpu_count()} CPUs)")
    for path, fn in (
        ("witness", lambda: matchers["witness"](chars[:B_LATENCY], lengths[:B_LATENCY])),
        ("tiled_witness", lambda: matchers["tiled_witness"](tiled4, lengths[:B_LATENCY])),
        ("tiled_match", lambda: matchers["tiled_match"](tiled4, lengths[:B_LATENCY])),
        ("match", lambda: matchers["match"](chars[:B_LATENCY], lengths[:B_LATENCY])),
        ("extract_serving", lambda: serve(full_m, chars[:B_LATENCY], lengths[:B_LATENCY])),
        ("pallas_from", lambda: mf(chars[:B_LATENCY], lengths[:B_LATENCY])),
    ):
        t = time_ms(fn, flush, device_only=False)
        times[f"latency_b{B_LATENCY}_{path}"] = {"kernel": t}
        log(f"[6] B={B_LATENCY} {path}: {fmt(t)} per call; card {card}")

    for layout, runs_ in cli_runs.items():
        log(f"[6] cli_scan {layout}: bytes_per_sec {[r['bytes_per_sec'] for r in runs_]}, "
            f"wall_seconds {[r['wall_seconds'] for r in runs_]} (two runs in process; file "
            f"reads, host packing and copies included); card {card}")
    for key, runs_ in dx_runs.items():
        log(f"[6] ScanJob {key}-packed: bytes_per_sec {[r['bytes_per_sec'] for r in runs_]}, "
            f"wall_seconds {[r['wall_seconds'] for r in runs_]} (runs 1 and 2 of the turns "
            f"host, device, device, host; file reads and copies included); card {card}")

    # [7] where the time goes on the table and portable paths (profiler;
    # walls above)
    for path, m in (*tables.items(), *portable.items()):
        ch, ln = (portable_io if path in portable else table_io)[path]
        prof = profile_call(lambda: m(ch, ln))
        wall = times[f"end_to_end_{path}"]["kernel"]["median"]
        prof["idle_share"] = 1 - prof["busy_ms"] / wall
        times[f"profile_{path}"] = prof
        log(f"[7] {path}: device busy {prof['busy_ms']:.4f} ms per call over "
            f"{prof['n_kernels']:.0f} kernels, idle share {prof['idle_share']:.4f} of the "
            f"{wall:.4f} ms wall; card {card}")
        log(f"[7]   kernels (ms per call): "
            + "; ".join(f"{k} {v:.4f}" for k, v in prof["kernels"]))
        log(f"[7]   host (ms per call): " + "; ".join(f"{k} {v:.4f}" for k, v in prof["host"]))

    # [4]-[6] of the knob paths and scan_planes; their mode rows ride under
    # the existing kernels' rows
    kp_rec = knob_paths(h2r, bp, kernels, knob_ms, hdr, chars, lengths,
                        dict(len_wb=len_wb, bits=bits_p, en=en_p, logs=logs_p), twins,
                        oracle_rows, idx, flush, card)
    for row in kern_rows:
        if row["name"] in kp_rec["modes"]:
            row["modes"] = kp_rec["modes"][row["name"]]
    kern_rows += kp_rec["rows"]
    times.update(kp_rec["times"])
    errs.update(kp_rec["errs"])
    path_launches.update(kp_rec["launches"])
    rec["match_ok"].update(kp_rec["match_ok"])
    # [8] the prover's flow and [9] the sharded matchers
    pv = prover_phase(h2r, kernels, native, model, matchers["witness"], full32, chars, lengths,
                      *corpora[L], card)
    mp, chars_p = perm_run
    pl = parallel_phase(h2r, kernels, model, model3, xla, mf, m3, mp, chars, lengths, chars3,
                        lengths3, chars_p, lengths_p, corpus_file, model_file,
                        cli_runs["bl"][0], flush, card, dev)
    del perm_run
    for f in (corpus_file, model_file):
        f.unlink()
    work.rmdir()
    rec.update(prover=pv["rec"], parallel=pl["rec"])
    path_launches.update(pv["launches"])
    path_launches.update(pl["launches"])
    times.update({f"parallel_{k}": v for k, v in pl["times"].items()})
    # [10] the serial-scan probes and the scans' place on their curves
    chain3 = kernels.table_scan_form(m3.n_defs, B3, m3.L, dev)
    pr = probe_phase(kernels, plan, times, chain3, m3.segment, card)
    kern_rows += pr["rows"]
    times.update(pr["times"])
    errs.update(pr["errs"])
    path_launches.update(pr["launches"])
    rec["probes"] = pr["rec"]
    # [11] the table-kernel probes, the lone chain beside configs[3]'s step
    tp = table_probe_phase(kernels, pr["rec"]["placement"]["table_scan_ns_a_chain_step"], card)
    kern_rows += tp["rows"]
    times.update(tp["times"])
    errs.update(tp["errs"])
    path_launches.update(tp["launches"])
    rec["table_probes"] = tp["rec"]
    # [12] the emission and decode probes, B14 beside the decode forms
    ep = emit_probe_phase(kernels, card)
    kern_rows += ep["rows"]
    times.update(ep["times"])
    errs.update(ep["errs"])
    path_launches.update(ep["launches"])
    rec["emit_probes"] = ep["rec"]
    # [13] the launch, accumulate, carry, class-chain and configs[3] step probes
    t2 = t2_probe_phase(kernels, m3, chars3, card)
    kern_rows += t2["rows"]
    times.update(t2["times"])
    errs.update(t2["errs"])
    path_launches.update(t2["launches"])
    rec["t2_probes"] = t2["rec"]
    # [14] the marker-stream verdict beside K2; the 64 KB and 200-word matchers
    t2c = t2c_probe_phase(kernels, times, card)
    kern_rows += t2c["rows"]
    times.update(t2c["times"])
    errs.update(t2c["errs"])
    path_launches.update(t2c["launches"])
    rec["t2c_probes"] = t2c["rec"]
    if sorted(r["name"] for r in kern_rows) != sorted(
            k.name for k in kernels.KERNELS + kernels.PROBE_KERNELS):
        raise AssertionError("the kernels line does not list every kernel once")

    log(f"phase walls (s, the time before each line by its tag): "
        f"{json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}")
    rec.update(times=times, launches=path_launches, kernels=kern_rows, max_abs_err=errs,
               phase_s=PHASE_S)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(json.dumps({"kernels": kern_rows}))
    log(smi())
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    try:
        result = main()
    except SystemExit:
        raise
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.exit(1)
    print(json.dumps(result), flush=True)
