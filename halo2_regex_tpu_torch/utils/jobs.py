"""Resumable corpus-scan jobs (the port of ``halo2_regex_tpu.utils.jobs``):
checkpoint/restart for long-running scans.

A job walks its corpus files in fixed byte chunks (cut at newline
boundaries), streams each chunk's padded batches through a matcher, and
persists ``(file index, byte offset, counters)`` as JSON after every chunk.
On restart the job seeks straight to the recorded offset: work since the
last checkpoint is redone, never skipped (at-least-once per chunk).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.bitplane import tile_corpus, tile_corpus_device
from ..ops.scan_torch import expand_rows
from .io import batch_iterator, flat_line_index, pack_lines
from .trace import Counters

# the batch of the tiled contract's throughput regime (bench.py's B)
TILED_MIN_BATCH = 32768


@dataclass
class JobState:
    file_idx: int = 0
    offset: int = 0
    n_truncated: int = 0
    counters: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path) -> "JobState":
        with open(path) as f:
            return cls(**json.load(f))

    def save(self, path) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.__dict__, f)
        os.replace(tmp, path)  # atomic on POSIX


class ScanJob:
    """Checkpointable scan over newline-delimited corpus files.

    Args:
      matcher: any batched matcher (``ops.best_matcher``).
      paths: corpus files (processed in sorted order).
      checkpoint_path: JSON state file; absent -> fresh start.
      batch_size / max_len: batch shape (max_len defaults to the model's).
      chunk_bytes: checkpoint granularity.
      on_batch: optional callback ``(result, chars, lengths, n_valid)``.
      prefetch: chunks read and packed (or indexed) ahead of the matcher
        by a worker thread (host work only: it makes no CUDA call); 0
        disables it.
      device_expand: upload each chunk's raw bytes once and gather the
        padded [B, max_len] rows on the matcher's device
        (``ops.scan_torch.expand_rows``; a tiled matcher's words by
        ``ops.bitplane.tile_corpus_device``), in place of uploading padded
        host batches.  Off by default, as in JAX: the JAX package measured
        it slower over its TPU link, which compressed the padding away.
        Whether the card over PCIe gains is recorded in PERF.md, not
        assumed.
    """

    def __init__(
        self,
        matcher,
        paths: Sequence[str],
        checkpoint_path: Optional[str] = None,
        batch_size: int = 1024,
        max_len: Optional[int] = None,
        chunk_bytes: int = 64 << 20,
        on_batch: Optional[Callable] = None,
        keep_newline: bool = False,
        prefetch: int = 2,
        device_expand: Optional[bool] = None,
    ):
        self.matcher = matcher
        self.paths: List[str] = sorted(paths)
        self.checkpoint_path = checkpoint_path
        self.batch_size = batch_size
        self.max_len = max_len or matcher.model.max_chars_size
        self.chunk_bytes = chunk_bytes
        self.on_batch = on_batch
        self.keep_newline = keep_newline
        self.prefetch = prefetch
        self.device_expand = bool(device_expand)
        self.n_truncated = 0  # total truncated lines after run()

    def _raw_chunks(self, state: JobState):
        """Yield (file_idx, end_offset, data bytes) per corpus chunk (cut
        at newline boundaries), starting from the checkpointed position."""
        for file_idx in range(state.file_idx, len(self.paths)):
            path = self.paths[file_idx]
            offset = state.offset if file_idx == state.file_idx else 0
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                while offset < size:
                    f.seek(offset)
                    data = f.read(self.chunk_bytes)
                    at_eof = offset + len(data) >= size
                    if at_eof:
                        consumed = len(data)
                    else:
                        cut = data.rfind(b"\n")
                        if cut < 0:
                            # A single line longer than the chunk.  Never
                            # split it mid-line (fragments could spuriously
                            # match and inflate counters): keep its first
                            # max_len+1 bytes (enough for pack_lines to
                            # truncate and count it exactly once) and skip
                            # forward to its newline.
                            keep = self.max_len + 1
                            head = data[:keep]
                            consumed = len(data)
                            while True:
                                more = f.read(self.chunk_bytes)
                                if not more:
                                    break
                                nl = more.find(b"\n")
                                take = len(more) if nl < 0 else nl + 1
                                if len(head) < keep:
                                    head += more[: min(take, keep - len(head))]
                                consumed += take
                                if nl >= 0:
                                    break
                            data = head
                        else:
                            data = data[: cut + 1]
                            consumed = cut + 1
                    offset += consumed
                    yield file_idx, offset, data

    def _packed_chunks(self, state: JobState):
        """Host-packed form: (file_idx, end_offset, chars, lengths, trunc)."""
        for file_idx, end_offset, data in self._raw_chunks(state):
            chars, lengths, trunc = pack_lines(data, self.max_len, self.keep_newline)
            yield file_idx, end_offset, chars, lengths, trunc

    def _indexed_chunks(self, state: JobState):
        """Device-expand form: (file_idx, end_offset, data, starts,
        lengths, trunc), the rows indexed and the bytes left in place."""
        for file_idx, end_offset, data in self._raw_chunks(state):
            starts, lengths, trunc = flat_line_index(data, self.max_len, self.keep_newline)
            yield file_idx, end_offset, data, starts, lengths, trunc

    def run(self) -> Counters:
        state = JobState()
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            state = JobState.load(self.checkpoint_path)
        counters = Counters(**state.counters).start()

        if self.device_expand:
            return self._run_device_expand(state, counters)
        chunks = self._packed_chunks(state)
        if self.prefetch:
            # read+pack the next chunk(s) while the matcher scans this one.
            # The checkpoint only advances when a chunk's batches have all
            # been consumed, so prefetched but unprocessed chunks are simply
            # re-read on restart.
            chunks = _prefetched(chunks, self.prefetch)
        # input_layout="tiled" matchers take the pretiled quad-word buffer
        # (ops.bitplane.tile_corpus), packed on the host per batch: the
        # corpus-controlled caller the tiled contract exists for
        tiled = self._tiled()
        for file_idx, end_offset, chars, lengths, trunc in chunks:
            state.n_truncated += trunc
            for bchars, blens, n_valid in batch_iterator(chars, lengths, self.batch_size):
                if tiled:
                    bchars = tile_corpus(bchars, self.matcher.L_pad)
                res = self.matcher(bchars, blens)
                counters.update(res, blens, n_valid)
                if self.on_batch is not None:
                    self.on_batch(res, bchars, blens, n_valid)
            state.file_idx = file_idx
            state.offset = end_offset
            state.counters = counters.snapshot()
            if self.checkpoint_path:
                state.save(self.checkpoint_path)
        self.n_truncated = state.n_truncated
        counters.finish()
        return counters

    def _tiled(self) -> bool:
        tiled = getattr(self.matcher, "input_layout", "bl") == "tiled"
        if tiled and self.batch_size < TILED_MIN_BATCH:
            print(
                f"warning: tiled input is a throughput-regime contract "
                f"(B>={TILED_MIN_BATCH}); batch_size={self.batch_size} underfills "
                f"the pack grid (PERF.md section 5 has the card's walls per layout "
                f"and batch size)",
                file=sys.stderr,
            )
        return tiled

    def _run_device_expand(self, state: JobState, counters: Counters) -> Counters:
        """The device-expand form of ``run``: each chunk's raw bytes go to
        the matcher's device in one copy (through a pinned host buffer on
        the card), into a buffer of chunk_bytes + max_len bytes (the JAX
        upload shape), and each batch's rows are gathered there.  The
        prefetch worker only reads and indexes; the copy is made here, in
        the consuming thread."""
        dev = self.matcher.device
        size = self.chunk_bytes + self.max_len
        buf = torch.empty(size, dtype=torch.uint8, device=dev)
        host = torch.empty(size, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        host_np = host.numpy()
        B = self.batch_size
        tiled = self._tiled()
        chunks = self._indexed_chunks(state)
        if self.prefetch:
            chunks = _prefetched(chunks, self.prefetch)
        for file_idx, end_offset, data, starts, lengths, trunc in chunks:
            state.n_truncated += trunc
            n_bytes = len(data)
            host_np[:n_bytes] = np.frombuffer(data, np.uint8)
            # a synchronous copy: the next chunk rewrites the host buffer;
            # the rows only read bytes below n_bytes
            buf[:n_bytes].copy_(host[:n_bytes])
            n = len(starts)
            for b0 in range(0, n, B):
                n_valid = min(B, n - b0)
                bs = np.zeros((B,), np.int64)
                bl = np.zeros((B,), np.int32)
                bs[:n_valid] = starts[b0 : b0 + n_valid]
                bl[:n_valid] = lengths[b0 : b0 + n_valid]
                blens = torch.from_numpy(bl).to(dev)
                bchars = expand_rows(buf, torch.from_numpy(bs).to(dev), blens, self.max_len)
                if tiled:
                    bchars = tile_corpus_device(bchars, self.matcher.L_pad)
                res = self.matcher(bchars, blens)
                counters.update(res, bl, n_valid)
                if self.on_batch is not None:
                    self.on_batch(res, bchars, bl, n_valid)
            state.file_idx = file_idx
            state.offset = end_offset
            state.counters = counters.snapshot()
            if self.checkpoint_path:
                state.save(self.checkpoint_path)
        self.n_truncated = state.n_truncated
        counters.finish()
        return counters


def _prefetched(gen, depth: int):
    """Drain ``gen`` in a daemon thread into a bounded queue (pipeline IO
    and packing with consumption); exceptions propagate to the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    _END = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate into the consuming thread
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
