"""Device grid and distributed-runtime helpers (the port of
``halo2_regex_tpu.parallel.mesh``).

JAX runs one controller over a ``jax.sharding.Mesh`` and lets ``shard_map``
place each shard.  The port runs one process over a ``Mesh`` of
``torch.device``s: a ``[data, seq]`` grid whose axes keep JAX's names.  The
sharded matchers run each shard's work on its own device and move the
cross-shard values (halo columns, boundary states, reductions) between
devices as tensors.  ``torch.distributed`` is used only where JAX uses
``jax.distributed``: across processes (``parallel.launch``).

A device may appear more than once in the grid.  ``[torch.device("cpu")] *
8`` is the counterpart of the eight virtual CPU devices the JAX tests get
from ``--xla_force_host_platform_device_count=8``, and ``[cuda:0] * 4``
runs a four-shard grid on one card.  Repeating a device runs its shards
one after another there: it checks the sharded arithmetic, it does not
make anything faster.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"


class Mesh:
    """A ``[data, seq]`` grid of ``torch.device``s.  ``shape`` maps each
    axis name to its size, as the JAX mesh's does; ``devices`` is the
    grid as an object array."""

    def __init__(self, devices: np.ndarray, axis_names=(DATA_AXIS, SEQ_AXIS)):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, i: int, j: int = 0) -> torch.device:
        """The device of data shard ``i``, sequence shard ``j``."""
        return self.devices[i, j]

    def __repr__(self) -> str:
        grid = [[str(d) for d in row] for row in self.devices]
        return f"Mesh({self.shape}, devices={grid})"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Join this process to a ``torch.distributed`` group (the counterpart
    of ``jax.distributed.initialize``): ``tcp://<coordinator_address>``,
    ``num_processes`` ranks, this one ``process_id``, over gloo for
    ``device="cpu"`` and nccl for ``"cuda"``.  A no-op for one process
    without a coordinator; a coordinator with ``num_processes=1`` makes a
    group of one (its collectives run, on one rank)."""
    import torch.distributed as dist

    n = num_processes or 1
    if n <= 1 and coordinator_address is None:
        return
    if coordinator_address is None:
        raise ValueError(f"{n} processes need a coordinator address (host:port)")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device={device!r}: expected cpu or cuda")
    dist.init_process_group(
        backend="gloo" if device == "cpu" else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=n,
        rank=process_id or 0,
    )


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` without an index as the current CUDA device, the device a
    tensor moved there reports (a mesh's devices key its shards' work)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    data: Optional[int] = None,
    seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(data, seq)`` mesh over the given devices, by default
    every visible CUDA device once (raising where there is none).

    ``data`` defaults to ``n_devices // seq``.  The data axis is the outer
    axis and the sequence axis the inner one, as in JAX.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= (for example "
                "[torch.device('cpu')] * 8) to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_indexed(torch.device(d)) for d in devices]
    n = len(devs)
    if data is None:
        if n % seq != 0:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        data = n // seq
    if data * seq != n:
        raise ValueError(f"mesh {data}x{seq} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, seq), (DATA_AXIS, SEQ_AXIS))


def shard_batch_size(global_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(per-shard batch, n_shards) for the data axis; global must divide."""
    n = mesh.shape[DATA_AXIS]
    if global_batch % n != 0:
        raise ValueError(f"batch {global_batch} not divisible by data axis {n}")
    return global_batch // n, n
