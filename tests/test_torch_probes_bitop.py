"""bitop_scan's table form (P4) and chains' fixed form (P5): their torch
twins against the plain versions and the probes of ``tools/``.

- ``bitop_table_plain`` (0/1 tensors, an entry an element) equals the
  probe's op sequence run bit-sliced in numpy, 32 entries a word, on all
  2^18 entries at every n_ops of the sweep; ``table_words`` packs it as
  ``csrc/probe_tpu20.cu`` reads it; the table kernel's index (a warp
  transpose by rotations, a funnel shift across words) and lookup
  arithmetic (one product), emulated here as the source has them, give
  the same entries, and the whole kernel so emulated equals the plain
  version;
- ``bitop_scan_table_plain`` (T walked string by string) equals
  ``bitop_scan_plain`` bit for bit, and through it probe_tpu20's
  ``make_scan_probe`` in interpret mode (outputs shared through a
  module-scoped fixture); a flipped entry and a dropped restart of acc are
  told apart;
- ``chains_fixed_plain`` equals ``chains_plain`` and probe_tpu56's
  ``make_chains_kernel``, its steps count against a walk made here.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_regex_tpu_torch.probes import probe_tpu20 as p20
from halo2_regex_tpu_torch.probes import probe_tpu56 as p56

from test_torch_probes import _HashStart, _hash_like, _load, _t

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "halo2_regex_tpu_torch", "csrc")
SMEM_OPTIN = 232448  # the H100's shared memory a block may opt into


def _constants(name: str) -> dict:
    text = open(os.path.join(CSRC, name)).read()
    return dict(re.findall(r"\b(k\w+) = (\d+)[,;]", text))


# ------------------------------------------------------------ the table


def _bitsliced_table(n_ops: int, sb: int = p20.SB, k: int = p20.K) -> np.ndarray:
    """T by the probe's ops on uint32 words, entry e at bit e % 32 of word
    e // 32, its class bits 0..k-1 and state bits k.. (as the build kernel
    lays them out)."""
    first = np.arange(0, 1 << (sb + 1 + k), 32, dtype=np.uint64)[:, None]
    bit = np.arange(32, dtype=np.uint64)

    def word(pos):  # bit `pos` of the word's 32 entries
        return ((((first + bit) >> np.uint64(pos)) & np.uint64(1)) << bit).sum(1).astype(np.uint32)

    cw = [word(c) for c in range(k)]
    planes = [word(k + j) for j in range(sb)]
    acc = word(k + sb)
    for t in range(n_ops):
        a, c = planes[t % sb], cw[t % k]
        if t % 3 == 0:
            acc = acc ^ (a & c)
        elif t % 3 == 1:
            acc = acc | (a & ~c)
        else:
            planes[t % sb] = a ^ acc
    b32 = np.arange(32, dtype=np.uint32)
    out = ((acc[:, None] >> b32) & 1) << sb
    for j in range(sb):
        out |= ((planes[j][:, None] >> b32) & 1) << j
    return out.reshape(-1).astype(np.int64)


@pytest.mark.parametrize("n_ops", p20.N_OPS)
def test_table_plain_equals_bitsliced_circuit(n_ops):
    T = p20.bitop_table_plain(n_ops)
    assert T.dtype == torch.int32 and tuple(T.shape) == (64, 4096)
    assert np.array_equal(T.reshape(-1).numpy(), _bitsliced_table(n_ops))
    # every state is reached, so the table cannot be narrowed
    assert len(set(T.reshape(-1).tolist())) == 64


def test_table_geometry_matches_the_kernel():
    got = _constants("probe_tpu20.cu")
    assert int(got["kTabPerWord"]) == p20.TABLE_PER_WORD
    assert (got["kTabSB"], got["kTabK"]) == (str(p20.SB), str(p20.K))
    assert p20.TABLE_ROW_WORDS == 820 and p20.TABLE_WORDS * 4 == 209920
    # T, the ring's stages of 8 words' padded columns, two output stages
    stages, steps, warps = (int(got[k]) for k in ("kTsStages", "kTsG", "kTsWarps"))
    smem = 4 * (p20.TABLE_WORDS + stages * warps * (steps * 12 + 4) + 2 * warps * (steps + 4))
    assert (stages, steps, warps) == (3, 16, 8) and smem <= SMEM_OPTIN
    assert steps * 12 % 32 == 0  # a stage's rows fill whole transposes


def _source(name: str) -> str:
    return open(os.path.join(CSRC, name)).read()


def _kernel_lookup_constants() -> tuple:
    """The table scan's lookup arithmetic as ``stage_steps`` ships it: the
    product's factor and the shifts giving T's byte offset in the row and
    the entry's shift."""
    text = _source("probe_tpu20.cu")
    mul = re.search(r"idx \* (\d+)u;", text)
    at = re.search(r"\(prod >> (\d+)\) & ~3u\)", text)
    sh = re.search(r"\(prod >> (\d+)\) & 30u;", text)
    assert mul and at and sh, "stage_steps' lookup arithmetic changed"
    assert "mad.lo.u32 %0, %1, %2, %3;" in text and '"n"(4 * kTabRowWords)' in text
    return int(mul.group(1)), int(at.group(1)), int(sh.group(1))


def _lookup(words: np.ndarray, st: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The kernel's read of T (``words``: ``table_words`` as uint32) at
    state st and class idx: the packed word (st * 4 * 820 + 4 (idx / 5)
    as a byte address) and the entry's shift (6 (idx % 5)), both from one
    product; returns (word, shift)."""
    mul, at_shift, sh_shift = _kernel_lookup_constants()
    prod = (idx.astype(np.uint64) * mul) & 0xFFFFFFFF
    at = (prod >> np.uint64(at_shift)) & np.uint64(0xFFFFFFFC)
    sh = (prod >> np.uint64(sh_shift)) & np.uint64(30)
    addr = st.astype(np.uint64) * (4 * p20.TABLE_ROW_WORDS) + at
    assert not (addr % 4).any()
    return words[(addr // 4).astype(np.int64)], sh


def _uint32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("n_ops", [96, 768])
def test_table_words_lookup_as_the_kernel(n_ops):
    """Every (state, class) entry read as ``stage_steps`` reads it: idx *
    52429, ``(prod >> 16) & ~3`` the byte offset of its word in the row,
    ``(prod >> 13) & 30`` its shift; the acc bit by the ballot's predicate
    ``w & (32 << sh)``."""
    T = p20.bitop_table_plain(n_ops)
    words = _uint32(p20.table_words(T))
    st = np.repeat(np.arange(64), 4096)
    idx = np.tile(np.arange(4096), 64)
    w, sh = _lookup(words, st, idx)
    want = T.reshape(-1).numpy()
    assert np.array_equal((w >> sh) & np.uint64(63), want)
    assert np.array_equal((w & (np.uint64(32) << sh)) != 0, (want >> 5) & 1 == 1)


def _warp_transpose(rows: np.ndarray) -> np.ndarray:
    """The kernel's ``transpose32`` on [..., 32] uint64 (lane r holds row
    r): five stages, each a shuffle with lane r ^ j, a rotation by j (top
    lanes) or 32 - j, and a select of the bits the lane keeps."""
    x = rows.astype(np.uint64)
    lane = np.arange(32)
    left = [0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555]
    for k, j in enumerate((16, 8, 4, 2, 1)):
        top = (lane & j) == 0
        keep = np.where(top, left[k], ~left[k] & 0xFFFFFFFF).astype(np.uint64)
        rot = np.where(top, j, 32 - j).astype(np.uint64)
        y = x[..., lane ^ j]
        r = ((y << rot) | (y >> (np.uint64(32) - rot))) & 0xFFFFFFFF
        x = (x & keep) | (r & ~keep & 0xFFFFFFFF)
    return x


def _funnelshift_r(lo: np.ndarray, hi: np.ndarray, r: int) -> np.ndarray:
    return (((hi << np.uint64(32)) | lo) >> np.uint64(r)) & 0xFFFFFFFF


def _step_index(xs: list, j: int) -> np.ndarray:
    """Step j's 12 class bits from a stage's transposed words, as
    ``stage_steps`` extracts them: bits 12 j .. 12 j + 11 of the string,
    across two words by a funnel shift."""
    b = p20.K * j
    k, r = b // 32, b % 32
    if r + p20.K <= 32:
        return (xs[k] >> np.uint64(r)) & 0xFFF
    return _funnelshift_r(xs[k], xs[k + 1], r) & 0xFFF


def test_kernel_stage_geometry():
    """A stage as the emulation below lays it out: 16 steps, their 192
    rows in 6 transposed words, each read by ``transpose32`` and a step's
    index by a funnel shift."""
    steps = int(_constants("probe_tpu20.cu")["kTsG"])
    assert steps == 16 and steps * p20.K // 32 == 6
    text = _source("probe_tpu20.cu")
    assert "__funnelshift_r(xs[k], xs[k + (k + 1 < kTsX)], r)" in text
    assert "transpose32(col[32 * k + lane], keep, rot)" in text
    # the restart the emulation runs: acc from plane 0, and where it falls
    assert "st = (st & 31u) | ((st & 1u) << 5);" in text
    assert "if (left >= kTsG)" in text and "if (!RESTART) left -= kTsG;" in text
    # the last step's bits end the stage's last word: no read past it
    assert (p20.K * (steps - 1)) % 32 + p20.K <= 32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_index_by_warp_transpose(seed):
    """A stage's 192 (step q, class c) rows, row 12 q + c, contiguous and
    unpadded, transposed 32 at a time into 6 words: lane b's step-j index
    (funnel shift across words where its 12 bits straddle two) is string
    b's 12 class bits of step j, for every j in 0..15."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2**32, size=(16, 12), dtype=np.uint64)  # [step, class]
    rows = cls.reshape(-1)
    xs = [_warp_transpose(rows[32 * k: 32 * k + 32]) for k in range(6)]
    lane = np.arange(32, dtype=np.uint64)
    for j in range(16):
        want = sum(((cls[j, c] >> lane) & 1) << np.uint64(c) for c in range(12))
        assert np.array_equal(_step_index(xs, j), want), j


def _emulate_table_scan(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, lc: int,
                        seed: int = 0) -> torch.Tensor:
    """``bitop_table_scan_kernel`` in numpy, every warp (word) at once:
    stages of 16 steps, rows past L holding stale words (random here);
    each stage's rows transposed, a step's index, the lookup of
    ``_lookup``, the restart of acc by the kernel's ``left`` count (a stage
    checks it a step only where a restart may fall in it), the acc bits by
    ballot; steps past L never stored."""
    G, S = 16, p20.SB
    L_, k, nws, lane_ = cls.shape
    nw = nws * lane_
    words = _uint32(p20.table_words(p20.bitop_table_plain(n_ops)))
    c = _uint32(cls).reshape(L_, k, nw)
    rng = np.random.default_rng(seed)
    lane = np.arange(32, dtype=np.uint64)
    s0 = _uint32(st0).reshape(S, nw)
    st = sum(((s0[j][:, None] >> lane) & 1) << np.uint64(j) for j in range(S))  # [NW, 32]
    out = np.zeros((L_, nw), np.uint64)
    left = 0
    for s in range(-(-L_ // G)):
        rows = rng.integers(0, 2**32, size=(G * k, nw), dtype=np.uint64)  # stale
        live = c[s * G:(s + 1) * G].reshape(-1, nw)
        rows[:live.shape[0]] = live
        xs = [_warp_transpose(rows[32 * i: 32 * i + 32].T) for i in range(G * k // 32)]
        restart = left < G
        for j in range(G):
            idx = _step_index(xs, j)
            if restart:
                if left == 0:
                    st = (st & 31) | ((st & 1) << np.uint64(5))
                    left = lc
                left -= 1
            w, sh = _lookup(words, st, idx)
            ballot = (((w & (np.uint64(32) << sh)) != 0).astype(np.uint64) << lane).sum(1)
            st = (w >> sh) & np.uint64(63)
            if s * G + j < L_:
                out[s * G + j] = ballot
        if not restart:
            left -= G
    return torch.from_numpy(out.astype(np.uint32).view(np.int32)).reshape(L_, 1, nws, lane_)


@pytest.mark.parametrize("n_ops,L,lc,nws", [(96, 100, 48, 1), (192, 37, 1, 1), (384, 64, 16, 2),
                                            (768, 50, 128, 1), (96, 200, 33, 1)])
def test_kernel_emulation_equals_plain(n_ops, L, lc, nws):
    """The table kernel as it ships, emulated (packing, transposes, index
    and lookup arithmetic, restart count, ballots): ``bitop_scan_plain``
    bit for bit on classes over the whole int32 range, at lengths that
    leave a partial stage, lc of 1, lc past L and lc not a multiple of the
    stage."""
    rng = np.random.default_rng(n_ops + L)
    cls = _t(rng.integers(-(2**31), 2**31, size=(L, 12, nws, 128), dtype=np.int64)
             .astype(np.int32))
    st0 = p20.inputs(1, nws, seed=L)[1]
    got = _emulate_table_scan(cls, st0, n_ops, lc, seed=lc)
    assert torch.equal(got, p20.bitop_scan_plain(cls, st0, n_ops, lc=lc))
    assert bool(got.any())


# ------------------------------------------------------- the table form


@pytest.fixture(scope="module")
def probe_scan():
    """probe_tpu20's make_scan_probe in interpret mode, one output a
    (n_ops, lc, start, classes) case: (cls, st0, out)."""
    got = {}

    def run(n_ops, lc, start, classes, L=256):
        key = (n_ops, lc, start, classes, L)
        if key not in got:
            rng = np.random.default_rng(n_ops + lc)
            hi = 2**31 if classes == "probe" else 2**32
            cls = rng.integers(0, hi, size=(L, 12, 1, 128), dtype=np.int64).astype(np.int32)
            free = dict(L=L, NWS=1, LANE=128)
            if start == "hash":
                free["jnp"] = _HashStart()
                st0 = np.asarray(jax.jit(_hash_like)(jnp.zeros((5, 1, 128), jnp.int32)))
            else:
                st0 = np.zeros((5, 1, 128), np.int32)
            make = _load("probe_tpu20.py", "make_scan_probe", **free)
            out = np.asarray(jax.jit(make(n_ops, lc=lc))(jnp.asarray(cls)))
            got[key] = (_t(cls), _t(st0), out)
        return got[key]

    return run


@pytest.mark.parametrize("n_ops,lc,start,classes,L", [
    (96, 128, "zero", "probe", 256), (96, 128, "hash", "probe", 256),
    (192, 128, "hash", "probe", 256), (96, 64, "hash", "full", 256),
    (384, 64, "hash", "full", 128), (768, 64, "hash", "probe", 128)])
def test_table_twin_equals_plain_and_probe(probe_scan, n_ops, lc, start, classes, L):
    cls, st0, want = probe_scan(n_ops, lc, start, classes, L)
    got = p20.bitop_scan_table_plain(cls, st0, n_ops, lc=lc)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p20.bitop_scan_plain(cls, st0, n_ops, lc=lc))
    assert bool(got.any()) == (start == "hash")
    if classes == "probe":  # bit 31 of every class word is 0: string 31 sees class 0
        assert not bool((cls < 0).any())


@pytest.mark.parametrize("n_ops,L,lc", [(96, 100, 48), (192, 30, 7), (384, 20, 3),
                                        (768, 17, 5), (96, 9, 128)])
@pytest.mark.parametrize("classes", ["probe", "full"])
def test_table_twin_equals_plain_any_lc(n_ops, L, lc, classes):
    """lc not dividing L (the probe's grid needs it to), a seeded start
    over the whole int32 range."""
    rng = np.random.default_rng(L * lc)
    cls, st0 = p20.inputs(L, 2, seed=L + lc)
    if classes == "full":
        cls = _t(rng.integers(-(2**31), 2**31, size=tuple(cls.shape), dtype=np.int64)
                 .astype(np.int32))
    got = p20.bitop_scan_table_plain(cls, st0, n_ops, lc=lc)
    assert torch.equal(got, p20.bitop_scan_plain(cls, st0, n_ops, lc=lc))
    assert bool(got.any())


def test_table_twin_mutants_are_told_apart(monkeypatch):
    """One entry flipped (the acc bit of the first string's first step),
    and the restart of acc dropped: each output differs from the plain
    version's."""
    cls, st0 = p20.inputs(64, 1, seed=11)
    want = p20.bitop_scan_plain(cls, st0, 96, lc=16)
    T = p20.bitop_table_plain(96)
    st = sum(((int(st0[j, 0, 0]) >> 0) & 1) << j for j in range(5))
    st |= (st & 1) << 5
    idx = sum(((int(cls[0, c, 0, 0]) >> 0) & 1) << c for c in range(12))
    flipped = T.clone()
    flipped[st, idx] ^= 32
    assert torch.equal(p20.bitop_scan_table_plain(cls, st0, 96, lc=16, table=T), want)
    assert not torch.equal(p20.bitop_scan_table_plain(cls, st0, 96, lc=16, table=flipped), want)
    monkeypatch.setattr(p20, "_restart", lambda st, sb: st)
    assert not torch.equal(p20.bitop_scan_table_plain(cls, st0, 96, lc=16, table=T), want)


def test_bitop_forms():
    cls, st0 = p20.inputs(16, 1, seed=2)
    want = p20.bitop_scan_plain(cls, st0, 96, lc=8)
    for form in (None, "table", "serial"):  # the CPU entry: the plain version
        assert torch.equal(p20.bitop_scan(cls, st0, 96, lc=8, form=form), want)
    assert p20.bitop_form(None) == "table" and p20.FORMS == ("table", "serial")
    with pytest.raises(ValueError, match="form 'slab'"):
        p20.bitop_scan(cls, st0, 96, form="slab")
    for form in p20.FORMS:
        with pytest.raises(ValueError, match="CUDA tensor"):
            p20.bitop_scan_cuda(cls, st0, 96, form=form)
        with pytest.raises(ValueError, match="built for n_ops"):
            p20.bitop_scan_cuda(cls, st0, 100, form=form)
    with pytest.raises(ValueError, match="CUDA device"):
        p20.bitop_table_cuda(96, torch.device("cpu"))
    with pytest.raises(ValueError, match="T: expected"):
        p20.table_words(torch.zeros((64, 100), dtype=torch.int32))


# ------------------------------------------------------- chains, fixed


def _steps_walked(x: torch.Tensor, n_steps: int) -> int:
    """The most steps a warp of 32 words runs in the fixed form, from a
    step-by-step walk: the first multiple of 4 (at most n_steps) after
    which every word of the warp is a fixed point, else n_steps."""
    v = x.reshape(x.shape[0], -1, 32)
    most = 0
    for w in range(v.shape[1]):
        y, ran = v[:, w], n_steps
        for i in range(1, n_steps + 1):
            y = (y ^ (y << 1)) & (y >> 1)
            if i % 4 == 0 and torch.equal((y ^ (y << 1)) & (y >> 1), y):
                ran = i
                break
        most = max(most, ran)
    return most


@pytest.fixture(scope="module")
def probe_chains():
    """probe_tpu56's make_chains_kernel in interpret mode: one output a
    (C, n_steps)."""
    got = {}

    def run(x, n_steps):
        key = (x.shape[0], n_steps, x.numpy().tobytes())
        if key not in got:
            make = _load("probe_tpu56.py", "make_chains_kernel", N_STEPS=n_steps)
            got[key] = np.asarray(jax.jit(make(x.shape[0]))(jnp.asarray(x.numpy())))
        return got[key]

    return run


@pytest.mark.parametrize("n_steps", [8, 21, 4096])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_chains_fixed_twin_equals_plain_and_probe(probe_chains, C, n_steps):
    """n_steps 8 is below the exit on the probe's input: every step runs."""
    x = p56.inputs(C, seed=C)
    out, steps = p56.chains_fixed_plain(x, n_steps)
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), probe_chains(x, n_steps))
    assert torch.equal(out, p56.chains_plain(x, n_steps))
    assert steps == _steps_walked(x, n_steps)
    if n_steps == 8:
        assert steps == 8
    if n_steps == 4096:
        assert steps <= 24  # the exit comes early on the probe's inputs


@pytest.mark.parametrize("n_steps", [0, 2, 4, 4096])
def test_chains_fixed_from_a_fixed_point(probe_chains, n_steps):
    """A start that is already a fixed point (the probe's input after 64
    steps) stops at the first check, 4 steps in; below a group it runs
    n_steps."""
    x = p56.chains_plain(p56.inputs(2, seed=0), 64)
    assert torch.equal((x ^ (x << 1)) & (x >> 1), x) and bool(x.any())
    out, steps = p56.chains_fixed_plain(x, n_steps)
    assert torch.equal(out, x) and np.array_equal(out.numpy(), probe_chains(x, n_steps))
    assert steps == min(n_steps, 4) == _steps_walked(x, n_steps)


def test_chains_fixed_words_past_a_warp():
    """A row that is no whole number of warps: the words past it count as
    zeros, a fixed point, in the last warp."""
    x = _t(np.random.default_rng(5).integers(-(2**31), 2**31, size=(2, 5, 9), dtype=np.int64)
           .astype(np.int32))
    out, steps = p56.chains_fixed_plain(x, 64)
    assert torch.equal(out, p56.chains_plain(x, 64)) and 4 <= steps <= 64


def test_chains_forms():
    x = p56.inputs(2, seed=3)
    for form in (None, "fixed", "serial"):
        assert torch.equal(p56.chains(x, 64, 32, form), p56.chains_plain(x, 64))
    assert p56.chains_form(None) == "fixed" and p56.FORMS == ("fixed", "serial")
    with pytest.raises(ValueError, match="form 'table'"):
        p56.chains(x, 64, form="table")
    for form in p56.FORMS:
        with pytest.raises(ValueError, match="CUDA tensor"):
            p56.chains_cuda(x, 64, 32, form)
    with pytest.raises(ValueError, match="threads"):
        p56.chains_cuda(x, 64, 64)
