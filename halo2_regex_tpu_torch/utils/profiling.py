"""Timing, roofline accounting and device specs: the port of
``halo2_regex_tpu/utils/profiling.py``.

The names, signatures and keys are the JAX module's (``device_specs``,
``ScanTraffic``, ``scan_roofline_bytes_per_sec``, ``result_nbytes``,
``benchmark``, ``benchmark_chained``), so a benchmark reads this module as
bench.py reads that one.  Beside them it holds the port's one copy of the
card's peaks (the bounds of chip_smoke and the probes read them from here)
and its one timer, ``time_ms``: CUDA events, the L2 flushed by a read
before each run (``L2Flush``), on the CPU the host clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Literal, Optional, Union

import numpy as np
import torch

# The H100 SXM5 (NVIDIA's H100 data sheet): HBM3 bytes/s, dense bf16
# FLOP/s and dense int8 OP/s on the tensor cores, SMs, boost clock, L2.
_H100_SMS, _H100_HZ = 132, 1.98e9

# Peak specs per device: "hbm_gbps" holds bytes/s, as in the JAX module.
# ``int32_ops`` (SMs x 64 INT32 lanes x clock) and ``half2_instrs`` (SMs x
# 128 lanes x clock: HSET2, HADD2, HFMA2, twice float32's rate outside the
# tensor cores) are the rates the port's bounds read beside the bytes.
_DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {
        "hbm_gbps": 3.35e12, "bf16_flops": 989e12, "int8_ops": 1979e12,
        "int32_ops": _H100_SMS * 64 * _H100_HZ, "half2_instrs": _H100_SMS * 128 * _H100_HZ,
        "sm_count": _H100_SMS, "clock_hz": _H100_HZ, "l2_bytes": 50 * 1024 * 1024,
    },
    "cpu": {"hbm_gbps": 50e9, "bf16_flops": 1e12, "int8_ops": 2e12},
}
H100_KIND = "NVIDIA H100 80GB HBM3"  # torch.cuda.get_device_name of the SXM card

FLUSH_BYTES = 128 * 1024 * 1024  # more than the 50 MiB L2
WARMUP, ITERS = 2, 10  # time_ms's untimed, then timed, calls


def spec_for_kind(kind: str) -> Dict[str, float]:
    """The row whose key is the longest one inside ``kind`` (case
    ignored), with ``kind`` added; a kind no key names raises (an unknown
    card takes no other card's peaks)."""
    hits = [key for key in _DEVICE_SPECS if key.lower() in str(kind).lower()]
    if not hits:
        raise ValueError(f"no peak specs for device kind {kind!r}")
    return dict(_DEVICE_SPECS[max(hits, key=len)], kind=str(kind))


def device_specs(device=None) -> Dict[str, float]:
    """The peaks of ``device`` (default: the current CUDA device, which
    must exist): a CUDA device by its name, the CPU by the CPU row."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cpu":
        return spec_for_kind("cpu")
    if d.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no peak specs for device {d}: torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()}")
    return spec_for_kind(torch.cuda.get_device_name(d))


@dataclass
class ScanTraffic:
    """Minimum HBM traffic per input byte for the fused witness scan.

    A speed-of-light fused kernel reads each input byte once and writes the
    compact witness row for it: masked char (1B) + substr id (1B) + state
    (2B) + packed flags (1B) = 5B out, 1B in; the tables stay on chip."""

    bytes_in_per_byte: float = 1.0
    bytes_out_per_byte: float = 5.0

    @property
    def total(self) -> float:
        return self.bytes_in_per_byte + self.bytes_out_per_byte


def scan_roofline_bytes_per_sec(device=None, traffic: Optional[ScanTraffic] = None) -> float:
    """Input-bytes/sec at the HBM roofline for the fused witness scan."""
    spec = device_specs(device)
    t = traffic or ScanTraffic()
    return spec["hbm_gbps"] / t.total


def _leaves(x):
    """The arrays of a result: through ``astuple()``, dicts, lists and
    tuples; ``None`` is no leaf (as in ``jax.tree.leaves``)."""
    if x is None:
        return
    if hasattr(x, "astuple"):
        x = x.astuple()
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def result_nbytes(result) -> int:
    """Total bytes of every array in a result (the emitted witness
    traffic, held against the ``ScanTraffic`` model): a tensor's
    ``numel() * element_size()``, a numpy array's ``nbytes``, anything
    else ``np.asarray(x).nbytes``."""
    total = 0
    for leaf in _leaves(result):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
        else:
            total += np.asarray(leaf).nbytes
    return int(total)


def _fetch(out):
    """Copy one element of the result's first array to the host.  A copy
    from the card waits for the work queued on the current stream (where
    the kernels launch), so it ends the call, as the JAX fetch does."""
    leaf = next(_leaves(out), None)
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().reshape(-1)[:1].cpu().numpy()
    return np.asarray(leaf).ravel()[:1]


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call on the host clock, each call ended by fetching a
    result element (``_fetch``): launch and copy-back included."""
    for _ in range(warmup):
        out = fn(*args)
        _fetch(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        _fetch(out)
    return (time.perf_counter() - t0) / iters


def benchmark_chained(
    make_chained: Callable[[int], Callable], args, ks=(1, 8), warmup: int = 1
) -> float:
    """Seconds per iteration by dependency chaining: ``make_chained(K)``
    returns a call running K data-dependent iterations; (t(K_hi) -
    t(K_lo)) / (K_hi - K_lo) cancels the fetch and the per-call cost."""
    k_lo, k_hi = ks
    f_lo, f_hi = make_chained(k_lo), make_chained(k_hi)
    for f in (f_lo, f_hi):
        for _ in range(warmup):
            _fetch(f(*args))

    def t(f, n=5):
        t0 = time.perf_counter()
        for _ in range(n):
            _fetch(f(*args))
        return (time.perf_counter() - t0) / n

    return max((t(f_hi) - t(f_lo)) / (k_hi - k_lo), 1e-9)


class L2Flush:
    """Evicts the card's L2 before a timed run: reads a buffer larger than
    it (the L2 then holds clean lines, which the timed call need not write
    back), or with ``write`` zeroes it (dirty lines: the flush before this
    module)."""

    def __init__(self, device=None, write: bool = False, buf: Optional[torch.Tensor] = None):
        self.buf = (buf if buf is not None else
                    torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                device=torch.device("cuda" if device is None else device)))
        self.write = write

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def __call__(self) -> None:
        if self.write:
            self.buf.zero_()
        else:
            self.buf.view(torch.int64).sum()


def time_ms(fn: Callable[[], object], device_only: bool = True,
            flush: Union[L2Flush, None, Literal[False]] = None, warmup: int = WARMUP,
            iters: int = ITERS, device=None) -> dict:
    """Median, IQR and every sample of ``fn``'s ms.

    On the card (CUDA events): the L2 is flushed before each run, outside
    the window, by ``flush`` (an ``L2Flush``; ``None``: a reading flush of
    a new buffer on the device; ``False``: none).  ``device_only``: a ~1 ms
    device spin is queued before the window, so the host has launched
    ``fn`` before the card reaches the start event and the window holds
    device time only; without it the window is what one call costs a
    caller.  On the CPU (``device``, else the flush's device, else CUDA)
    the host clock, no flush."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = flush.device if isinstance(flush, L2Flush) else torch.device("cuda")
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    else:
        if flush is None:
            flush = L2Flush(dev)
        torch.cuda.synchronize(dev)
        pairs = []
        for _ in range(iters):
            if flush:
                flush()
            if device_only:
                torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in pairs]
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "iqr": [float(q1), float(q3)],
            "all": [float(x) for x in ms], "runs": iters}
