"""Data-parallel matching over a device mesh (the port of
``halo2_regex_tpu.parallel.data_parallel``).

The batch is split over the mesh's data axis; each shard runs on its own
device against that device's copy of the model's tables, and only the
summary statistics (match counts, scanned and extracted bytes, failure
flags) reduce across shards.  JAX does this under one ``jit`` with the
batch sharded and lets XLA lower the sums to ``psum``; here each shard's
work is launched on its device in shard order, the per-shard statistics
are summed on the first device, and the outputs are concatenated there in
shard order, so the result equals the single-device matcher's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.compiled import CompiledRegexModel
from ..ops.scan_torch import _match_core, _model_arrays, arrays_on
from ..witness.result import RegexResult
from .mesh import DATA_AXIS, Mesh, make_mesh, shard_batch_size

STAT_KEYS = ("n_matched", "n_failed", "n_dead", "bytes_scanned", "extracted_bytes")


def shard_stats(out: dict, lengths: torch.Tensor) -> torch.Tensor:
    """The five statistics of one shard's output columns, as an int32
    [5] tensor in ``STAT_KEYS`` order (JAX's int32 sums)."""
    i32 = torch.int32
    ok = out["match_ok"]
    return torch.stack([
        ok.sum(dtype=i32),
        (~ok).sum(dtype=i32),
        out["has_dead"].any(1).sum(dtype=i32),
        lengths.sum(dtype=i32),
        (out["mask"] * out["all_enable_flags"]).sum(dtype=i32),
    ])


class DistributedMatcher:
    """Batched matcher whose batch is split over the data axis.

    Usage::

        mesh = make_mesh()                     # all devices on the data axis
        dm = DistributedMatcher(model, mesh)
        result, stats = dm(chars, lengths)     # chars [B, L] with B % n_data == 0

    ``backend="xla"`` runs the portable scan's ``_match_core`` on each
    shard (the table scan kernel on the card); ``"pallas"`` one
    ``PallasMatcher`` a device (``pallas_kwargs`` go to its constructor).
    Data shard ``i`` runs on ``mesh.device(i, 0)`` (a seq axis replicates
    the data shards in JAX: one replica does the work here).  The result
    lies on ``mesh.device(0, 0)``; ``stats`` maps ``STAT_KEYS`` to int32
    numpy scalars.
    """

    def __init__(
        self,
        model: CompiledRegexModel,
        mesh: Optional[Mesh] = None,
        backend: str = "xla",
        pallas_kwargs: Optional[dict] = None,
    ):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh()
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend={backend!r}: expected xla/pallas")
        self.backend = backend
        devices = [self.mesh.device(i) for i in range(self.mesh.shape[DATA_AXIS])]
        if backend == "pallas":
            from ..ops.pallas_scan import PallasMatcher

            self.pallas = {d: PallasMatcher(model, device=d, **(pallas_kwargs or {}))
                           for d in dict.fromkeys(devices)}
        else:
            arrays = _model_arrays(model)
            self.arrays = {d: arrays_on(arrays, d) for d in dict.fromkeys(devices)}

    def _shard(self, dev: torch.device, chars: torch.Tensor, lengths: torch.Tensor) -> dict:
        if self.backend == "pallas":
            return vars(self.pallas[dev].run(chars, lengths))
        return _match_core(self.arrays[dev], self.model.n_defs, chars, lengths)

    @torch.no_grad()
    def __call__(self, chars, lengths):
        chars = torch.as_tensor(chars, dtype=torch.uint8)
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        Bs, n = shard_batch_size(chars.shape[0], self.mesh)
        home = self.mesh.device(0)
        outs, stats = [], []
        for i in range(n):
            dev = self.mesh.device(i)
            ch = chars[i * Bs:(i + 1) * Bs].to(dev).contiguous()
            ln = lengths[i * Bs:(i + 1) * Bs].to(dev).contiguous()
            out = self._shard(dev, ch, ln)
            stats.append(shard_stats(out, ln).to(home))
            outs.append({k: v.to(home) for k, v in out.items()})
        result = RegexResult(**{k: torch.cat([o[k] for o in outs]) for k in outs[0]})
        total = torch.stack(stats).sum(0, dtype=torch.int32).cpu().numpy()
        return result, {k: np.asarray(v) for k, v in zip(STAT_KEYS, total)}
