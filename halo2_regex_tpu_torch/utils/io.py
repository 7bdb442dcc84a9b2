"""Corpus loading (the port of ``halo2_regex_tpu.utils.io``): stream
newline-delimited byte corpora into padded batches.

Files are read in chunks, split and padded by the native C++ packer where
g++ exists (numpy otherwise), and yielded as (chars [B, L] uint8, lengths
[B] int32, n_valid) host batches.  Multi-process sharding is by
round-robin file assignment per process.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .. import native


def pack_lines(
    data: bytes, max_len: int, keep_newline: bool = False
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Split a newline-delimited buffer into (chars, lengths, n_truncated);
    the native packer where g++ exists, else numpy (same arrays).

    ``keep_newline`` restores each line's terminating ``\\n`` byte (the
    on-disk bytes, e.g. the ``\\r\\n`` the email-header DFAs require to
    reach their accept state: without it a corpus scan of those models
    matches nothing)."""
    if native.available():
        return native.pack_lines(data, max_len, keep_newline)
    lines = data.split(b"\n")
    last_had_nl = bool(lines) and lines[-1] == b""
    if last_had_nl:
        lines.pop()
    chars = np.zeros((len(lines), max_len), np.uint8)
    lengths = np.zeros((len(lines),), np.int32)
    truncated = 0
    for i, ln in enumerate(lines):
        if keep_newline and (i < len(lines) - 1 or last_had_nl):
            ln = ln + b"\n"
        if len(ln) > max_len:
            truncated += 1
            ln = ln[:max_len]
        chars[i, : len(ln)] = bytearray(ln)
        lengths[i] = len(ln)
    return chars, lengths, truncated


def pack_batch(strings, max_chars_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of byte strings into (chars [B, L] uint8, lengths [B]
    int32); a string longer than ``max_chars_size`` raises ``ValueError``
    (the JAX package's ``ops.scan_jax.pack_batch``)."""
    B = len(strings)
    chars = np.zeros((B, max_chars_size), np.uint8)
    lengths = np.zeros((B,), np.int32)
    for i, s in enumerate(strings):
        b = bytes(s)
        if len(b) > max_chars_size:
            raise ValueError(f"string {i} length {len(b)} > {max_chars_size}")
        chars[i, : len(b)] = bytearray(b)
        lengths[i] = len(b)
    return chars, lengths


def batch_iterator(
    chars: np.ndarray,
    lengths: np.ndarray,
    batch_size: int,
    drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield fixed-size (chars, lengths, n_valid) batches, zero-padding the
    final partial batch (one shape for every call) unless drop_remainder;
    n_valid counts the non-padding rows."""
    n = chars.shape[0]
    full = n // batch_size
    for b in range(full):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        yield chars[sl], lengths[sl], batch_size
    rem = n - full * batch_size
    if rem and not drop_remainder:
        pad_chars = np.zeros((batch_size, chars.shape[1]), np.uint8)
        pad_lens = np.zeros((batch_size,), np.int32)
        pad_chars[:rem] = chars[full * batch_size :]
        pad_lens[:rem] = lengths[full * batch_size :]
        yield pad_chars, pad_lens, rem


class CorpusLoader:
    """Stream one or more newline-delimited corpus files as padded batches.

    For a multi-process run, pass (process_index, process_count) to take a
    round-robin shard of the file list (data-parallel input sharding).
    """

    def __init__(
        self,
        paths: Sequence[str],
        max_len: int,
        batch_size: int,
        read_chunk_bytes: int = 64 << 20,
        process_index: int = 0,
        process_count: int = 1,
        keep_newline: bool = False,
    ):
        self.paths = [p for i, p in enumerate(sorted(paths))
                      if i % process_count == process_index]
        self.max_len = max_len
        self.batch_size = batch_size
        self.read_chunk_bytes = read_chunk_bytes
        self.keep_newline = keep_newline
        self.n_truncated = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        carry_chars: List[np.ndarray] = []
        carry_lens: List[np.ndarray] = []
        carried = 0
        for path in self.paths:
            with open(path, "rb") as f:
                tail = b""
                while True:
                    chunk = f.read(self.read_chunk_bytes)
                    if not chunk:
                        break
                    data = tail + chunk
                    # keep the final partial line for the next chunk
                    cut = data.rfind(b"\n")
                    if cut < 0:
                        tail = data
                        continue
                    tail = data[cut + 1 :]
                    chars, lengths, trunc = pack_lines(
                        data[: cut + 1], self.max_len, self.keep_newline
                    )
                    self.n_truncated += trunc
                    carry_chars.append(chars)
                    carry_lens.append(lengths)
                    carried += chars.shape[0]
                    while carried >= self.batch_size:
                        allc = np.concatenate(carry_chars)
                        alll = np.concatenate(carry_lens)
                        yield allc[: self.batch_size], alll[: self.batch_size], self.batch_size
                        carry_chars = [allc[self.batch_size :]]
                        carry_lens = [alll[self.batch_size :]]
                        carried = carry_chars[0].shape[0]
                if tail:
                    chars, lengths, trunc = pack_lines(
                        tail, self.max_len, self.keep_newline
                    )
                    self.n_truncated += trunc
                    carry_chars.append(chars)
                    carry_lens.append(lengths)
                    carried += chars.shape[0]
        if carried:
            allc = np.concatenate(carry_chars)
            alll = np.concatenate(carry_lens)
            yield from batch_iterator(allc, alll, self.batch_size)


def flat_line_index(data: bytes, max_len: int, keep_newline: bool = False):
    """Index a newline-delimited buffer without copying it into padded
    rows: returns (starts int64 [N], lengths int32 [N], n_truncated), the
    row index a device-side expansion of the raw buffer gathers by."""
    arr = np.frombuffer(data, np.uint8)
    nl = np.nonzero(arr == 0x0A)[0]
    tail = len(data) > 0 and (len(nl) == 0 or nl[-1] != len(data) - 1)
    n = len(nl) + (1 if tail else 0)
    starts = np.zeros((n,), np.int64)
    if len(nl):
        starts[1 : len(nl) + (1 if tail else 0)] = nl[: n - 1] + 1
    ends = np.empty((n,), np.int64)
    ends[: len(nl)] = nl + (1 if keep_newline else 0)
    if tail:
        ends[-1] = len(data)
    lengths = ends - starts
    n_trunc = int((lengths > max_len).sum())
    lengths = np.minimum(lengths, max_len).astype(np.int32)
    return starts, lengths, n_trunc
