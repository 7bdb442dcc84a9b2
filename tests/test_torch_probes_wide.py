"""The redesigned dfa_wide forms' decompositions (``csrc/probe_dfa_wide.cu``),
as torch twins, against the probes themselves and the plain version.

- ``wide_mma_cluster``: the product form.  The strings in rows of 64 (a
  warpgroup's), each step's one-hot built as the kernel's half2 compares
  (a class less k % 8 against k - k % 8, in fp16; a class out of range
  as -1024, which matches no column), T's columns split over R ranks
  (NR = ceil(W / R) rounded up to 8 a rank, each rank's slice staged
  from ``b_fragments`` as f16), the per-rank products in f32, each rank's
  words of every string (column s, and S + s with hi/lo, where it holds
  the column, else 0) sent into every rank's exchange slot of the step
  (t mod the kernel's slots), and every rank summing the ranks' words
  into lo + 256 hi (mod S).  R = 1, 2, 16 (the kernel's at 96 x 2016)
  and 5 (which does not divide W).
- ``wide_lookup_chunks``: the chunked lookup, thread by thread.  The
  decoded table [K + 1][S + 1] of byte offsets 2 min(next, S) (column S and
  row K zero); S1 a walker a (string, chunk): from the entry state W
  positions before the chunk (from 0 if that comes first), its guess g
  and end e kept as states clamped to S, a next state past S written as
  itself; S2 a walker a string: the chunks whose guess differs from the
  true end before them walked again, overwriting, until the walk meets
  the stored state, the overwritten positions counted.

Both are held to probe_tpu28's v2, probe_tpu30's w1 and w2 and the w3
chain (interpret mode, the fixtures of tests/test_torch_probes_t2b.py)
and to ``dfa_wide_plain`` on ragged TB and L, classes and entry states
out of range, every flag; the lookup twin also on a table that resyncs
(some chunks repaired) and a permutation table (every chunk repaired),
its count against ``probe_tpu28.lookup_chunks_plain``'s.  Each twin has
one mutation the probes tell apart: the exchange read from the step
before's slot; a repair that stops one step before its chunk's end.
The twins' geometry is read from the kernel's source.  The kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_regex_tpu_torch.ops import kernels
from halo2_regex_tpu_torch.probes import probe_tpu28 as p28
from halo2_regex_tpu_torch.probes import probe_tpu30 as p30

from test_torch_probes import _t
from test_torch_probes_t2b import tpu28_calls, tpu30  # noqa: F401  (module fixtures)


def _cu_int(pattern: str) -> int:
    """The integer that ``pattern``'s group matches in csrc/probe_dfa_wide.cu."""
    m = re.search(pattern, (Path(kernels.CSRC) / "probe_dfa_wide.cu").read_text())
    assert m, f"no {pattern!r} in csrc/probe_dfa_wide.cu"
    return int(m.group(1))


# a rank's n tile, the largest cluster, a cluster's strings, the exchange's slots
MMA_N, MAX_CLUSTER, STRINGS, SLOTS = (_cu_int(rf"constexpr int {n} = (\d+);")
                                      for n in ("kMmaN", "kMaxCluster", "kStrings", "kSlots"))


def _classes(chars: torch.Tensor, K: int, cmod: bool) -> torch.Tensor:
    c = torch.remainder(chars.long(), K) if cmod else chars.long()
    return torch.where((c >= 0) & (c < K), c, -1024)


def kernel_ranks(W: int) -> int:
    """The kernel's cluster: the fewest ranks whose slices fit one n tile."""
    return min(MAX_CLUSTER, -(-W // MMA_N))


def wide_mma_cluster(tbl, chars, hilo=False, cmod=False, smod=False, entry=None, R=None,
                     stale=False) -> torch.Tensor:
    """The product form, rank by rank (``R``: the cluster, the kernel's
    when None).  ``stale``: every rank reads the step before's slot (its
    picks; a mutation the tests tell apart)."""
    K, W = tbl.shape
    S = W // 2 if hilo else W
    L, TB = chars.shape
    R = kernel_ranks(W) if R is None else R
    NR = -(-(-(-W // R)) // 8) * 8
    Kp = -(-K // 16) * 16
    # each rank's slice from the fragments, as the kernel stages it: f16 [Kp, NR]
    fr = p28.b_fragments(tbl)
    k = torch.arange(Kp)[:, None]
    slices = []
    for r in range(R):
        col = r * NR + torch.arange(NR)[None, :]
        inside = (col < W).expand(Kp, -1)
        bits = torch.zeros((Kp, NR), dtype=torch.int16)
        cc, kk = col.expand(Kp, -1)[inside], k.expand(-1, NR)[inside]
        bits[inside] = fr[cc // 8, kk // 16, 4 * (cc % 8) + (kk % 8) // 2,
                          2 * ((kk % 16) // 8) + kk % 2]
        slices.append(bits.view(torch.bfloat16).float().half())
    rows = -(-TB // STRINGS) * STRINGS  # whole warpgroups: padded rows walk unstored
    cls = torch.full((L, rows), -1024, dtype=torch.int64)
    cls[:, :TB] = _classes(chars, K, cmod)
    s = torch.zeros(rows, dtype=torch.int64)
    if entry is not None:
        s[:TB] = entry.long()
    base = (torch.arange(Kp) - torch.arange(Kp) % 8).half()  # 16 kt + 8 h
    off = (torch.arange(Kp) % 8).half()  # 2 q + e
    # every rank's exchange [slot][sender][row][lo, hi]
    xbuf = torch.zeros((R, SLOTS, R, rows, 2), dtype=torch.int64)
    out = torch.empty((L, TB), dtype=torch.int32)
    for t in range(L):
        a = ((cls[t].half()[:, None] - off[None, :]) == base[None, :]).half()  # HSET2
        prods = [(a.float() @ sl.float()) for sl in slices]  # [rows, NR] f32 a rank
        q = t % SLOTS
        inr = (s >= 0) & (s < S)
        for r in range(R):  # rank r's words, sent to every rank
            words = torch.zeros((rows, 2), dtype=torch.int64)
            for kind in range(2 if hilo else 1):
                col = s + kind * S
                local = col - r * NR
                mine = inr & (local >= 0) & (local < NR) & (col < W)
                words[mine, kind] = prods[r][mine.nonzero()[:, 0], local[mine]].long()
            xbuf[:, q, r] = words
        x = xbuf[0, (q - 1) % SLOTS if stale else q].sum(0)  # rank 0's sum of the ranks' words
        v = x[:, 0] + 256 * x[:, 1]
        s = v % S if smod else v
        out[t] = s[:TB].to(torch.int32)
    return out


def wide_lookup_chunks(tbl, chars, hilo=False, cmod=False, smod=False, entry=None,
                       C=kernels.TABLE_SCAN_C, W=kernels.TABLE_SCAN_W, early=False):
    """The chunked lookup (S1, S2) thread by thread: (states, positions
    repaired).  ``early``: a repair stops one position before its chunk's
    end (a mutation the tests tell apart)."""
    K, Wt = tbl.shape
    S = Wt // 2 if hilo else Wt
    L, TB = chars.shape
    v = tbl.float().long()
    nxt = v[:, :S] + 256 * v[:, S:] if hilo else v
    if smod:
        nxt = nxt % S
    tab = torch.zeros((K + 1, S + 1), dtype=torch.int64)  # 2 min(next, S); column S, row K zero
    tab[:K, :S] = 2 * nxt.clamp(max=S)
    tab, nxt = tab.tolist(), nxt.tolist()
    rows = _classes(chars, K, cmod).clamp(min=-1).tolist()  # -1: row K
    entry = [0] * TB if entry is None else entry.tolist()
    out = [[0] * TB for _ in range(L)]

    def walk(b, x, a, e, store):
        for i in range(a, e):
            xp, x = x, tab[rows[i][b]][x // 2]
            if store:  # a next state past S, written as itself
                out[i][b] = nxt[rows[i][b]][xp // 2] if x == 2 * S else x // 2
        return x

    n_ch = -(-L // C)
    g = [[0] * TB for _ in range(n_ch)]
    e = [[0] * TB for _ in range(n_ch)]
    for c in range(n_ch):  # S1
        cs, ce = c * C, min(c * C + C, L)
        for b in range(TB):
            x = 2 * entry[b] if 0 <= entry[b] < S else 2 * S
            x = walk(b, x, max(0, cs - W), cs, False)
            g[c][b] = x // 2
            e[c][b] = walk(b, x, cs, ce, True) // 2
    repaired = 0
    for b in range(TB):  # S2
        end = e[0][b]
        for c in range(1, n_ch):
            cs, ce = c * C, min(c * C + C, L)
            if end == g[c][b]:
                end = e[c][b]
                continue
            x, met = 2 * end, False
            for i in range(cs, ce - 1 if early else ce):
                xp, x = x, tab[rows[i][b]][x // 2]
                s = nxt[rows[i][b]][xp // 2] if x == 2 * S else x // 2
                if s == out[i][b]:
                    met = True
                    break
                out[i][b] = s
                repaired += 1
            end = e[c][b] if met else x // 2
    return torch.tensor(out, dtype=torch.int32).reshape(L, TB), repaired


def _inputs(K, S, hilo, L, TB, seed, lo=0, hi=None):
    """A table (hi/lo values under 256, else under S + 2: some states past
    S), chars in [lo, hi) and an entry with states past S."""
    rng = np.random.default_rng(seed)
    top = 256 if hilo else S + 2
    tbl = p28.as_table(rng.integers(0, top, size=(K, 2 * S if hilo else S)).astype(np.float32))
    chars = _t(rng.integers(lo, K if hi is None else hi, size=(L, TB)).astype(np.int32))
    entry = _t(rng.integers(0, S + 3, size=TB).astype(np.int32))
    return tbl, chars, entry


# ---------------------------------------------------------------- the products


def test_cluster_geometry():
    """configs[3]'s 96 x 2016 table: 16 ranks of 128 columns (the last
    96), one n tile each; a table of at most 128 columns on one rank."""
    assert (MMA_N, MAX_CLUSTER, STRINGS) == (128, 16, 64)
    assert kernel_ranks(2016) == 16 and kernel_ranks(128) == 1 and kernel_ranks(32) == 1
    assert -(-2016 // 16) <= MMA_N


@pytest.mark.parametrize("R", [1, 2, 16, 5])
def test_mma_cluster_equals_v2(tpu28_calls, R):
    """v2 (hi/lo, c mod 96, s mod S over 96 x 2016) at every cluster,
    5 ranks of 408 columns among them (the last 384)."""
    tbl, chars = p28.as_table(tpu28_calls["tbl"]), _t(tpu28_calls["chars"])
    got = wide_mma_cluster(tbl, chars, hilo=True, cmod=True, smod=True, R=R)
    assert np.array_equal(got.numpy(), tpu28_calls["v2"])


def test_mma_cluster_equals_w1_w2_and_chain(tpu30):
    """w1 from zeros, w2 from an entry state, and w3: two calls chained at
    the first's last row equal one."""
    tbl, chars, entry = tpu30["tbl"], tpu30["chars"], tpu30["entry"]
    assert np.array_equal(wide_mma_cluster(tbl, chars, **p30.FLAGS).numpy(), tpu30["w1"])
    one = wide_mma_cluster(tbl, chars, entry=entry, **p30.FLAGS)
    assert np.array_equal(one.numpy(), tpu30["w2"])
    h = chars.shape[0] // 2
    first = wide_mma_cluster(tbl, chars[:h].contiguous(), entry=entry, **p30.FLAGS)
    second = wide_mma_cluster(tbl, chars[h:].contiguous(), entry=first[-1], **p30.FLAGS)
    assert torch.equal(torch.cat([first, second]), one)


@pytest.mark.parametrize("K,S,hilo,cmod,smod,R", [
    (96, 1008, True, False, True, None), (40, 300, False, False, True, 3),
    (17, 60, True, True, False, None), (100, 77, False, False, False, 2),
    (16, 24, False, True, False, None), (33, 129, False, False, False, None)])
def test_mma_cluster_equals_plain(K, S, hilo, cmod, smod, R):
    """Ragged TB (70: two warpgroups, the second partial) and L (37), K
    and W that fill no tile, classes out of range (below 0 and past K)
    and entry states past S, next states past S (no smod), one rank (W
    <= 128) and several."""
    tbl, chars, entry = _inputs(K, S, hilo, 37, 70, K + S, lo=-5, hi=K + 9)
    want = p28.dfa_wide_plain(tbl, chars, hilo, cmod, smod, entry)
    assert torch.equal(wide_mma_cluster(tbl, chars, hilo, cmod, smod, entry, R=R), want)
    assert len(torch.unique(want)) > 8


def test_mma_cluster_stale_slot_is_told_apart(tpu28_calls):
    """The exchange read from the step before's slot differs from v2 and
    from plain."""
    tbl, chars = p28.as_table(tpu28_calls["tbl"]), _t(tpu28_calls["chars"])
    got = wide_mma_cluster(tbl, chars, hilo=True, cmod=True, smod=True, R=16, stale=True)
    assert not np.array_equal(got.numpy(), tpu28_calls["v2"])
    tbl, chars, entry = _inputs(40, 300, False, 37, 70, 9)
    assert not torch.equal(wide_mma_cluster(tbl, chars, entry=entry, stale=True),
                           p28.dfa_wide_plain(tbl, chars, entry=entry))


# ---------------------------------------------------------------- the lookup


@pytest.mark.parametrize("C,W", [(8, 4), (16, 0), (64, 8192)])
def test_lookup_chunks_equal_v2(tpu28_calls, C, W):
    """v2 in chunks of 8 after 4 positions of warm-up (guesses that miss),
    without warm-up, and in one chunk; the count as lookup_chunks_plain's."""
    tbl, chars = p28.as_table(tpu28_calls["tbl"]), _t(tpu28_calls["chars"])
    got, n = wide_lookup_chunks(tbl, chars, True, True, True, C=C, W=W)
    assert np.array_equal(got.numpy(), tpu28_calls["v2"])
    pkg, n_pkg = p28.lookup_chunks_plain(tbl, chars, True, True, True, C=C, W=W)
    assert torch.equal(pkg, got) and n == n_pkg
    if C == 64:
        assert n == 0


def test_lookup_chunks_equal_w1_w2_and_chain(tpu30):
    tbl, chars, entry = tpu30["tbl"], tpu30["chars"], tpu30["entry"]
    w1, _ = wide_lookup_chunks(tbl, chars, C=16, W=8, **p30.FLAGS)
    assert np.array_equal(w1.numpy(), tpu30["w1"])
    one, _ = wide_lookup_chunks(tbl, chars, entry=entry, C=16, W=8, **p30.FLAGS)
    assert np.array_equal(one.numpy(), tpu30["w2"])
    h = chars.shape[0] // 2
    first, _ = wide_lookup_chunks(tbl, chars[:h].contiguous(), entry=entry, C=8, W=4,
                                  **p30.FLAGS)
    second, _ = wide_lookup_chunks(tbl, chars[h:].contiguous(), entry=first[-1], C=8, W=4,
                                   **p30.FLAGS)
    assert torch.equal(torch.cat([first, second]), one)


@pytest.mark.parametrize("K,S,hilo,cmod,smod", [
    (96, 1008, True, True, True), (40, 300, False, False, False),
    (17, 60, True, False, False), (12, 40, False, True, True)])
def test_lookup_chunks_equal_plain(K, S, hilo, cmod, smod):
    """Ragged TB (37) and L (150: a partial last chunk), classes and entry
    states out of range, next states past S (no smod: written as
    themselves, walked as S), chunks of 16 after 8 positions of warm-up;
    the count as lookup_chunks_plain's."""
    tbl, chars, entry = _inputs(K, S, hilo, 150, 37, 3 * K + S, lo=-5, hi=K + 9)
    want = p28.dfa_wide_plain(tbl, chars, hilo, cmod, smod, entry)
    got, n = wide_lookup_chunks(tbl, chars, hilo, cmod, smod, entry, C=16, W=8)
    assert torch.equal(got, want)
    pkg, n_pkg = p28.lookup_chunks_plain(tbl, chars, hilo, cmod, smod, entry, C=16, W=8)
    assert torch.equal(pkg, want) and n == n_pkg


def _permutation(K=6, S=50, L=120, TB=9, seed=4):
    rng = np.random.default_rng(seed)
    tbl = p28.as_table(np.stack([rng.permutation(S) for _ in range(K)]).astype(np.float32))
    chars = _t(rng.integers(0, K, size=(L, TB)).astype(np.int32))
    return tbl, chars


def test_lookup_chunks_repair_a_permutation_everywhere():
    """A permutation table never resyncs: past the first chunk each
    chunk is repaired wherever its guess was wrong (all but the positions
    where a wrong walk happens to agree), and the count is the package
    twin's; a table that resyncs within its warm-up needs no repair."""
    tbl, chars = _permutation()
    want = p28.dfa_wide_plain(tbl, chars)
    got, n = wide_lookup_chunks(tbl, chars, C=16, W=8)
    assert torch.equal(got, want)
    assert n == p28.lookup_chunks_plain(tbl, chars, C=16, W=8)[1]
    assert n >= 0.9 * (120 - 16) * 9
    tbl, chars, _e = _inputs(12, 20, False, 150, 37, 5)
    assert wide_lookup_chunks(tbl, chars, C=16, W=128)[1] == 0


def test_lookup_chunks_early_repair_is_told_apart():
    """A repair that stops one step early leaves the last position of each
    repaired chunk as speculated."""
    tbl, chars = _permutation()
    got, _ = wide_lookup_chunks(tbl, chars, C=16, W=8, early=True)
    assert not torch.equal(got, p28.dfa_wide_plain(tbl, chars))
