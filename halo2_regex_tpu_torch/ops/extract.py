"""Device-side run extraction: masked witness columns -> compact tuples.

The port of ``halo2_regex_tpu.ops.extract``.  ``extract_substrings``
(ops/reference.py) decodes masked runs on the host, which means shipping
the full [B, L] masked columns back per batch; ``extract_runs`` decodes
the runs where the columns are, into fixed-shape arrays -- one (offset,
length, id, bytes) record per extracted substring -- so only
O(B * max_runs * max_len) bytes need to leave the device.

Torch ops with no data-dependent shapes.  Runs never nest, so run r
starts at the (r+1)-th start of its row and ends at the (r+1)-th end:
the running counts of starts and of ends are sorted along the row, and
one ``searchsorted`` of 1..max_runs into each gives every run slot (the
JAX version takes max_runs masked min/max reductions per field, which XLA
fuses into one pass; in eager torch each would be a pass of its own over
[B, L]).  The JAX version's optimization barrier (which stops XLA fusing
the witness decode into each reduction) has no eager counterpart and is
dropped.  Dtypes are the JAX package's: int32 offsets, lengths, ids and
n_runs, uint8 bytes.
"""

from __future__ import annotations

from typing import Dict

import torch


def extract_runs(
    all_substr_ids: torch.Tensor,  # [B, L] masked ids (0 = no substring)
    masked_characters: torch.Tensor,  # [B, L]
    max_runs: int = 4,
    max_len: int = 0,  # 0 = skip byte payloads
) -> Dict[str, torch.Tensor]:
    """Decode masked runs into fixed-shape arrays.

    Returns ``offsets``/``lengths``/``ids`` of shape [B, max_runs]
    (``offsets`` = -1 past the last run), ``n_runs`` [B] (the true run
    count, so ``n_runs > max_runs`` flags dropped runs), and, when
    ``max_len`` > 0, ``bytes`` [B, max_runs, max_len] uint8, zero padded.
    """
    a = all_substr_ids
    B, L = a.shape
    nz = a != 0
    is_start = nz.clone()
    is_start[:, 1:] &= a[:, 1:] != a[:, :-1]
    is_end = nz
    is_end[:, :-1] &= a[:, :-1] != a[:, 1:]
    ranks = torch.arange(1, max_runs + 1, dtype=torch.int32, device=a.device)
    ranks = ranks.expand(B, max_runs).contiguous()

    def nth(mask):  # [B, max_runs] position of each row's r-th True (L: none), count
        # torch's cumsum of bool widens to int64; JAX keeps int32
        counts = torch.cumsum(mask, 1, dtype=torch.int32)
        return torch.searchsorted(counts, ranks, out_int32=True), counts[:, -1]

    offsets_raw, n_runs = nth(is_start)
    offsets = torch.where(offsets_raw < L, offsets_raw, -1)
    valid = offsets >= 0
    lengths = torch.where(valid, nth(is_end)[0] - offsets + 1, 0)
    first = torch.gather(a, 1, offsets_raw.clamp(max=L - 1).long()).to(torch.int32)
    out = dict(offsets=offsets, lengths=lengths, ids=torch.where(valid, first, 0),
               n_runs=n_runs)
    if max_len:
        # a max_len window from each run start (clamped; masked chars are
        # 0 outside runs so over-reads self-clean), one [B, R*max_len]
        # gather on the original rows
        base = offsets.clamp(0, L - 1)
        win = base[:, :, None] + torch.arange(max_len, dtype=torch.int32, device=a.device)
        win = win.clamp(0, L - 1).reshape(B, max_runs * max_len)
        payload = torch.gather(masked_characters, 1, win.long()).reshape(B, max_runs, max_len)
        inlen = torch.arange(max_len, device=a.device)[None, None, :] < lengths[:, :, None]
        out["bytes"] = torch.where(valid[:, :, None] & inlen, payload, 0).to(torch.uint8)
    return out


def runs_to_python(out: Dict[str, torch.Tensor], row: int):
    """Host-side view of one string's runs as (offset, text, id) tuples
    (mirrors ops/reference.extract_substrings)."""
    offs = out["offsets"][row].cpu().numpy()
    ids = out["ids"][row].cpu().numpy()
    res = []
    if "bytes" in out:
        payload = out["bytes"][row].cpu().numpy()
        lens = out["lengths"][row].cpu().numpy()
        for r in range(offs.shape[0]):
            if offs[r] < 0:
                break
            res.append((int(offs[r]), bytes(payload[r][: lens[r]]).decode("latin-1"), int(ids[r])))
    else:
        for r in range(offs.shape[0]):
            if offs[r] < 0:
                break
            res.append((int(offs[r]), None, int(ids[r])))
    return res
