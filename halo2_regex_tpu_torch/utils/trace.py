"""Tracing and observability (the port of ``halo2_regex_tpu.utils.trace``).

  - :func:`profile` wraps a region with ``torch.profiler`` (writes a
    Chrome/perfetto trace into ``trace_dir``);
  - :func:`annotate` is ``torch.profiler.record_function``, so phases show
    up named in traces;
  - :class:`Counters` accumulates scan statistics (bytes, matches, dead
    states) across batches for corpus jobs, host-side; its fields and JSON
    are the JAX package's.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("halo2_regex_tpu_torch")

annotate = torch.profiler.record_function


@contextlib.contextmanager
def profile(trace_dir: Optional[str] = None):
    """Profile the enclosed region.  With ``trace_dir``, trace the CPU and
    (where present) the card and write ``trace.json`` there; otherwise
    just log the wall time."""
    t0 = time.perf_counter()
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    else:
        yield
    logger.info("profiled region: %.3fs", time.perf_counter() - t0)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class Counters:
    """Accumulated corpus-scan statistics."""

    batches: int = 0
    strings: int = 0
    bytes_scanned: int = 0
    matched: int = 0
    failed: int = 0
    dead: int = 0
    wall_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def update(self, result, lengths, n_valid: Optional[int] = None) -> None:
        # result may be a RegexResult or an emission dict (the bitplane
        # backend's columns="witness"/"match" modes); its verdicts may lie
        # on the card, and are fetched to the host in one transfer
        get = (
            result.__getitem__ if isinstance(result, dict)
            else lambda k: getattr(result, k)
        )
        ok, has_dead = get("match_ok"), get("has_dead")
        n = int(ok.shape[0]) if n_valid is None else n_valid
        if isinstance(ok, torch.Tensor):
            ok, dead = _host(torch.stack([ok[:n], has_dead[:n].any(-1)]))
        else:
            ok, dead = np.asarray(ok)[:n], np.asarray(has_dead)[:n].any(-1)
        self.batches += 1
        self.strings += n
        self.bytes_scanned += int(_host(lengths)[:n].sum())
        self.matched += int(ok.sum())
        self.failed += int((~ok).sum())
        self.dead += int(dead.sum())

    def finish(self) -> "Counters":
        if self._t0:
            self.wall_seconds += time.perf_counter() - self._t0
            self._t0 = 0.0
        return self

    def snapshot(self) -> dict:
        """JSON-safe public state (wall time accumulated to now): the
        checkpoint payload for resumable jobs (utils/jobs.py)."""
        live = time.perf_counter() - self._t0 if self._t0 else 0.0
        return {
            "batches": self.batches,
            "strings": self.strings,
            "bytes_scanned": self.bytes_scanned,
            "matched": self.matched,
            "failed": self.failed,
            "dead": self.dead,
            "wall_seconds": self.wall_seconds + live,
        }

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_scanned / self.wall_seconds if self.wall_seconds else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "batches": self.batches,
                "strings": self.strings,
                "bytes_scanned": self.bytes_scanned,
                "matched": self.matched,
                "failed": self.failed,
                "dead": self.dead,
                "wall_seconds": round(self.wall_seconds, 4),
                "bytes_per_sec": round(self.bytes_per_sec, 1),
            }
        )
