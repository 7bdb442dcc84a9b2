"""What the probe scripts share: the device choice, timing and reports.

A probe measures on the card or not at all: ``--device cuda`` (the
default) raises where CUDA is absent rather than fall back to the CPU, and
a CPU run reports host milliseconds (``host_ms``), never a card time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..utils import profiling

# the H100 SXM's boost clock (``profiling``'s row): cycles a step are quoted at it
CLOCK_HZ = profiling.spec_for_kind(profiling.H100_KIND)["clock_hz"]
WARMUP, ITERS = profiling.WARMUP, profiling.ITERS  # untimed calls, then timed ones


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) runs the kernels; cpu the plain versions")
    return p


def device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: run with --device cpu for the "
                         "plain versions")
    return torch.device(name)


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Timer:
    """Times calls on one device (``profiling.time_ms``): on the card with
    CUDA events, the L2 flushed by a read before each call and a device
    spin queued ahead of the window (so it holds device time only, no host
    launch overhead); on the CPU with the host clock."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.flush = profiling.L2Flush(dev) if dev.type == "cuda" else None

    def __call__(self, fn: Callable[[], object], warmup: Optional[int] = None,
                 iters: Optional[int] = None) -> Dict[str, object]:
        """Median and IQR of ``fn``'s ms, and the last call's output ("out");
        ``warmup`` and ``iters`` default to ``WARMUP`` and ``ITERS``."""
        last: List[object] = [None]

        def call():
            last[0] = fn()

        t = profiling.time_ms(call, True, flush=self.flush,
                              warmup=WARMUP if warmup is None else warmup,
                              iters=ITERS if iters is None else iters, device=self.dev)
        return {"median": t["median"], "iqr": t["iqr"], "runs": t["runs"], "out": last[0]}


def max_abs_err(a, b):
    """The largest difference of two outputs (tensors or tuples of them):
    an int for integer outputs, a float for floating ones; a shape or dtype
    that differs raises."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def within(got: torch.Tensor, want: torch.Tensor, tolerance: torch.Tensor) -> bool:
    """Every element of ``got`` within ``tolerance`` (elementwise) of
    ``want``."""
    return bool(((got.double() - want.double()).abs() <= tolerance.double()).all())


def measure(timer: Timer, card_: str, probe: str, kernel: kernels.CudaKernel,
            fn: Callable[[], object], steps: int, plain, library=None, nbytes: int = 0,
            int32_ops: int = 0, half2_ops: int = 0, calls: int = 1,
            tolerance: Optional[torch.Tensor] = None,
            library_exact: bool = True, warmup: Optional[int] = None,
            iters: Optional[int] = None, **kw) -> Tuple[Dict[str, object], object]:
    """One report line and ``fn``'s last output.

    On the card ``fn`` is the kernel's entry point: the launches of its
    first call are read around it from every kernel's count (it must launch
    ``kernel`` ``calls`` times and nothing else), then it is timed
    (``warmup`` and ``iters`` as ``Timer``'s), and its last timed output is
    held against the plain version's (``plain``: a call, timed once here,
    or its (output, ms) already taken): exactly, or where ``tolerance`` (a
    tensor of the output's shape) is given, within it elementwise
    (``within_tolerance``).  ``library``: one PyTorch call of the same
    function, held to the same output and timed beside it; with
    ``library_exact`` False its difference is recorded
    (``library_max_abs_err``), not held.  ``nbytes``, ``int32_ops`` and
    ``half2_ops`` (fp16x2 instructions) are the work a bound reads.  On the CPU ``fn`` runs the plain version
    itself, timed on the host."""
    rec: Dict[str, object] = {"probe": probe, "kernel": kernel.name, "device": timer.dev.type,
                              "card": card_, **kw}
    if timer.dev.type != "cuda":
        t = timer(fn, warmup, iters)
        rec.update(host_ms=t["median"], runs=t["runs"], steps=steps)
        return rec, t["out"]
    every = kernels.KERNELS + kernels.PROBE_KERNELS
    before = [k.launches for k in every]
    fn()
    launched = {k.name: k.launches - n for k, n in zip(every, before) if k.launches != n}
    if launched != {kernel.name: calls}:
        raise AssertionError(f"{probe}: one call launched {launched}, not {kernel.name} "
                             f"{calls} times")
    t = timer(fn, warmup, iters)
    if isinstance(plain, tuple):
        want, plain_ms = plain
    else:
        tp = timer(plain, 0, 1)
        want, plain_ms = tp["out"], tp["median"]
    lib_ms = None
    if library is not None:
        tl = timer(library)
        err = max_abs_err(tl["out"], want)
        if library_exact and err:
            raise AssertionError(f"{probe}: the library call disagrees with the plain version")
        if not library_exact:
            rec["library_max_abs_err"] = err
        lib_ms = tl["median"]
    ns = t["median"] * 1e6 / steps
    rec.update(ms=t["median"], iqr=t["iqr"], runs=t["runs"], steps=steps, ns_per_step=ns,
               cycles_per_step=ns * 1e-9 * CLOCK_HZ, cycles_at_hz=CLOCK_HZ,
               launches=launched[kernel.name], max_abs_err=max_abs_err(t["out"], want),
               plain_ms=plain_ms, library_ms=lib_ms, nbytes=nbytes, int32_ops=int32_ops)
    if half2_ops:
        rec["half2_ops"] = half2_ops
    if calls != 1:
        rec["calls"] = calls
    if tolerance is not None:
        rec["within_tolerance"] = within(t["out"], want, tolerance)
    return rec, t["out"]


def torch_line(timer: Timer, card_: str, probe: str, fn: Callable[[], object],
               warmup: Optional[int] = None, iters: Optional[int] = None,
               **kw) -> Tuple[Dict[str, object], object]:
    """One report line of a torch op that a probe script timed beside its
    kernels (the TPU scripts' lines with no Pallas kernel): ``"kernel":
    None``, device ms on the card (and the rates of the ``flops`` or
    ``nbytes`` given), host ms on the CPU; and ``fn``'s last output
    (``warmup`` and ``iters`` as ``Timer``'s)."""
    rec: Dict[str, object] = {"probe": probe, "kernel": None, "device": timer.dev.type,
                              "card": card_, **kw}
    t = timer(fn, warmup, iters)
    if timer.dev.type == "cuda":
        rec.update(ms=t["median"], iqr=t["iqr"], runs=t["runs"])
        if "flops" in kw:
            rec["tflops"] = kw["flops"] / (t["median"] * 1e-3) / 1e12
        if "nbytes" in kw:
            rec["gbytes_per_sec"] = kw["nbytes"] / (t["median"] * 1e-3) / 1e9
    else:
        rec.update(host_ms=t["median"], runs=t["runs"])
    return rec, t["out"]


def host_us(dev: torch.device, fn: Callable[[], object], n: int = 50) -> float:
    """Host microseconds a call over ``n`` back-to-back calls of ``fn``,
    then one synchronize (the TPU probes' dispatch timing)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n * 1e6


def wall_slope(dev: torch.device, chain: Callable[[int], object], ks: Tuple[int, int] = (8, 64),
               runs: int = 5) -> Dict[str, object]:
    """What one more call of a chain costs, host enqueue included:
    ``chain(k)`` enqueues k calls back to back.  On the card, each run
    flushes the L2 (a read, ``profiling.L2Flush``) and waits for it, then
    takes the host's wall clock from the first enqueue to
    ``torch.cuda.synchronize()`` (no spin ahead, so the host's enqueue
    counts) at both k, and the host's own part of it (to the
    last enqueue's return), then the device time of the same chain with a
    spin queued ahead of it (CUDA events: the device's own time a call,
    launch gaps included, the host's enqueue hidden); on the CPU the host
    clock alone.  Returns each k's wall and enqueue ms (median and IQR over
    ``runs``), the slope a call (ms, from each run's pair: median, IQR and
    every run's, "all") and, on the card, the device slope."""
    k0, k1 = ks
    flush = profiling.L2Flush(dev) if dev.type == "cuda" else None
    chain(k0)  # warm
    walls: Dict[int, List[float]] = {k0: [], k1: []}
    enqueue: Dict[int, List[float]] = {k0: [], k1: []}
    dev_ms: Dict[int, List[float]] = {k0: [], k1: []}
    for _ in range(runs):
        for k in ks:
            if flush is not None:
                flush()
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            chain(k)
            t1 = time.perf_counter()
            if flush is not None:
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            walls[k].append((t2 - t0) * 1e3)
            enqueue[k].append((t1 - t0) * 1e3)
            if flush is not None:
                flush()
                # a spin past the host's enqueue of the chain (twice this run's)
                torch.cuda._sleep(int(max(2e6, 2 * (t1 - t0) * CLOCK_HZ)))
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                chain(k)
                b.record()
                torch.cuda.synchronize(dev)
                dev_ms[k].append(a.elapsed_time(b))

    def stats(v: List[float], every: bool = False) -> Dict[str, object]:
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        return {"median": float(med), "iqr": [float(q1), float(q3)],
                **({"all": [float(x) for x in v]} if every else {})}

    out: Dict[str, object] = {
        "ks": [k0, k1], "runs": runs,
        "wall_ms": {str(k): stats(v) for k, v in walls.items()},
        "enqueue_ms": {str(k): stats(v) for k, v in enqueue.items()},
        "slope_ms": stats([(b - a) / (k1 - k0) for a, b in zip(walls[k0], walls[k1])], True)}
    if flush is not None:
        out["device_ms"] = {str(k): stats(v) for k, v in dev_ms.items()}
        out["device_slope_ms"] = stats([(b - a) / (k1 - k0)
                                        for a, b in zip(dev_ms[k0], dev_ms[k1])], True)
    return out


def emit(records: List[Dict[str, object]]) -> None:
    for r in records:
        print(json.dumps(r), flush=True)


def status(records: List[Dict[str, object]]) -> int:
    """A script's exit code: 1 where a kernel disagreed with its plain
    version (beyond its tolerance, where the line has one), else 0."""
    return int(any(r.get("max_abs_err") and not r.get("within_tolerance")
                   for r in records))
