"""The serial-scan probes of ``tools/`` as H100 kernels.

Each module keeps the name of the TPU script it ports, so a reader finds
its counterpart:

- :mod:`.probe_tpu9`: ``loop_floor`` (A and B, the floor of a serial loop,
  one row or eight a step) and ``slab_scan`` (C, the table scan's step);
- :mod:`.probe_tpu20`: ``bitop_scan`` (A, a serial bit-op scan swept over
  ops a step, at the bitplane scan's geometry);
- :mod:`.probe_tpu56`: ``chains`` (A, the issue width: 1, 2 or 4
  independent chains).

Every probe has a plain PyTorch version (``*_plain``), a kernel wrapper
(``*_cuda``, ``csrc/probe_tpu*.cu`` built with the other kernels by
:mod:`..ops.kernels`) and an entry point that picks one by the device of
its input: the kernel on a CUDA tensor, the plain version on a CPU one.
``python -m halo2_regex_tpu_torch.probes.probe_tpu9`` (and the others)
runs a probe on the card and prints one JSON line a measurement with the
card's name and power limit; ``--device cpu`` runs the plain versions at a
small size.  The modules import torch and numpy only; this package
imports none of them, so ``python -m`` runs each as it is.
"""
