"""The hardware probes of ``tools/`` as H100 kernels.

Each module keeps the name of the TPU script it ports, so a reader finds
its counterpart.  The serial-scan probes:

- :mod:`.probe_tpu9`: ``loop_floor`` (A and B: a column cumsum, one row or
  eight a step in its serial form) and ``slab_scan`` (C, the table scan's
  step), each a chunked scan over the card by default (``form``);
- :mod:`.probe_tpu20`: ``bitop_scan`` (A, a serial bit-op scan swept over
  ops a step, at the bitplane scan's geometry);
- :mod:`.probe_tpu56`: ``chains`` (A, the issue width: 1, 2 or 4
  independent chains).

The table-kernel probes:

- :mod:`.probe_tpu`: ``lane_gather`` (k3, k4; k5's rows mode
  ``row_gather``), the row in shared memory or registers, a chain of
  gathers by squaring or serially (``form``), and
  ``dfa_step`` (k6, k7: the DFA step by a lookup or a one-hot product on
  the tensor cores);
- :mod:`.probe_tpu2`: ``nop`` (A, the dispatch cost), ``dfa_step``
  time-major (C; D's class-factored product), the lone chain of dependent
  gathers (E) and ``onehot_count`` (F, the compare rate);
- :mod:`.probe_tpu3`: ``lane_gather`` by a [TB, 1] index and the gather
  loop, ``dfa_step``'s two picks (full-width gather, select sum);
- :mod:`.probe_tpu17`: ``int8_mma`` (an int8 product with int32 sums);
- :mod:`.probe_tpu18`: ``slab_anatomy`` (the table step with 1, 2 or 4
  picks and stores).

The emission and decode probes:

- :mod:`.probe_tpu47`: ``tile_move`` (the int32 tile transpose and copy);
- :mod:`.probe_tpu48`: ``l4_pack`` (byte-lane words to string-major
  l4-packed rows by byte permutes, an int32 tile transpose or the tensor
  cores: the direct [B, L] emission), beside the copy and the library's
  decode;
- :mod:`.probe_tpu64`: ``field_decode`` (B14's decode with the fields
  given, by an int32 tile transpose or the tensor cores) beside B14 and
  the torch tails, the primitives at the decode's block shapes, qpack
  alone;
- :mod:`.probe_tpu68`: the decode forms on the from: batch's g4 and the
  witness with each, in turns with the shipped emissions.

The launch, accumulate, carry, class-chain and configs[3] table-step
probes:

- :mod:`.probe_tpu67`: a launch's cost past its bytes (chains of
  ``tile_move`` copies, timed with the host's enqueue) and the witness's
  batch scaling;
- :mod:`.probe_tpu21`: ``mma_accum`` (a bf16 product accumulated in f32
  over a grid axis); :mod:`.probe_tpu20`'s D and E (``mma_accum``, and
  ``bitop_carry``: a state carried across chunks, an OR reduction over
  the card or serially, ``form``);
- :mod:`.probe_tpu6`: k1 (``loop_floor``), k2 (``dfa_wide``), k3 (the slab
  kernel, a packed table's second column), k4 (``class_chain``: a byte's
  class by a chain of compares or a 256-entry table);
- :mod:`.probe_tpu28`: ``dfa_wide`` (the DFA step on tables of up to 256 x
  1024, hi/lo, modulos, an entry state; lookup, one-hot products or v1's
  count) and the step at configs[3]'s batch beside B8;
  :mod:`.probe_tpu7`, :mod:`.probe_tpu30`, :mod:`.probe_tpu31`,
  :mod:`.probe_tpu32`: its bisects (S 32 to 1024, chunked and chained).

The marker-stream probes:

- :mod:`.probe_tpu57_lib`: the restricted from: verdict as bitstream
  operations (``marker_match``: serial, or in chunks whose summaries
  compose), its plain versions and its inputs;
- :mod:`.probe_tpu57`: the verdict beside K2 at B = 32768 and 4096 (B,
  C), the from: model at 64 KB strings on the bitplane and table paths
  (D) and a 200-word model's witness (E);
- :mod:`.probe_tpu61`: the same verdicts and K2 by the slope of chained
  calls (C).

Every probe has a plain PyTorch version (``*_plain``), a kernel wrapper
(``*_cuda``, ``csrc/probe_*.cu`` built with the other kernels by
:mod:`..ops.kernels`) and an entry point that picks one by the device of
its input: the kernel on a CUDA tensor, the plain version on a CPU one.
``python -m halo2_regex_tpu_torch.probes.probe_tpu9`` (and the others)
runs a probe on the card and prints one JSON line a measurement with the
card's name and power limit; ``--device cpu`` runs the plain versions at a
small size.  The modules import torch and numpy only; this package
imports none of them, so ``python -m`` runs each as it is.
"""
