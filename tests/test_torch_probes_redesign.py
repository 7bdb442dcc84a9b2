"""The redesigned onehot_count, mma_accum, int8_mma and dfa_step kernels'
decompositions, as torch twins, against the probes themselves and the
plain versions.

- ``onehot_count_slices``: the rows split over the ranks of a cluster in
  steps of warps x rows (slices that do not divide LB), each slice
  counted by 256 compares a byte (in fp16, as the kernel's half2 form, or
  in int32), the partials summed; against probe_tpu2.py's F (``k4``,
  interpret mode) and ``onehot_count_plain``.
- ``mma_accum_tiles``: the tile walk (the kernel's 128 x 128 or, past 128
  columns, 128 x 256 tiles, and others), tiles larger than M or N and k
  boxes past K zero-filled, one accumulator carried over l and stored at
  each l; against probe_tpu21.py's D (``mm_kern``, interpret mode, with
  its grid and block specs at each shape) and ``mma_accum_plain``: exact
  on integer inputs, within 2e-5 x sum |a b| on N(0, 1) inputs.

- ``int8_mma_tiles``: b staged K-major (b^T [N, Kp], Kp = K rounded up
  to 16, zeros past K), a copied to [M, Kp] where TMA cannot read it in
  place, the persistent blocks' tile walk (128 x 256 tiles past 128
  columns, else 128 x 128), k stages of 128 split into k32 slices, boxes
  past M, N and Kp zero-filled, int32 sums that wrap; against
  probe_tpu17.py's ``k`` (interpret mode) and ``int8_mma_plain`` on the
  probe's ranges and the whole int8 range (-128 included).
- ``dfa_lookup_tiles``: the lookup's persistent warps (a warp a tile of
  32 strings, a lane a string, the grid's warp g taking tiles g, g + its
  warps, ...), groups of steps that move as [steps, strings] tiles
  through the warp's ring slots, words past TB or LB neither fetched nor
  stored, T staged as it is; against k7 (interpret mode) and
  ``dfa_step_plain``, ragged TB and LB in both layouts.
- ``dfa_step_warpgroups``: the strings in rows of 64 (a warpgroup's, four
  warps of 16), each step's one-hot built as the kernel's half2 compares
  (a byte less (2 q, 2 q + 1) against (16 kt, 16 kt) and (16 kt + 8, 16 kt
  + 8), in fp16), the products (one-hot @ T, or one-hot @ C, the f32 class
  one-hot converted to f16 and fed back as A, @ Tk) into two accumulators,
  position t's in acc[t % 2], and each pick made one step late from the
  other; against the DFA-step probes of tests/test_torch_probes_table.py
  (k6, k7, C, D, fullwidth, select) and ``dfa_step_plain``.

The twins' geometry is read from the kernels' sources (``csrc/``), so a
change there is a change here.  Each twin has one mutation (a slice
counted twice; the accumulator reset at each l; a k32 slice read one byte
off; a group's first lookup from the state two steps back; a pick taken
from the position after its own) that the probe's
output tells apart, and the half2 form's claim (every int32 converts to
fp16 as a value in 0..255 only if it is that value) is checked on the
int32 edges.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from halo2_regex_tpu_torch.ops import kernels
from halo2_regex_tpu_torch.probes import probe_tpu as p1
from halo2_regex_tpu_torch.probes import probe_tpu2 as p2
from halo2_regex_tpu_torch.probes import probe_tpu17 as p17
from halo2_regex_tpu_torch.probes import probe_tpu21 as p21

from test_torch_probes import _Interpret, _load, _spec, _t
from test_torch_probes_table import _call, _i32, scans  # noqa: F401 (scans: a fixture)


def _cu_int(source: str, pattern: str) -> int:
    """The integer that ``pattern``'s group matches in ``csrc/<source>``."""
    m = re.search(pattern, (Path(kernels.CSRC) / source).read_text())
    assert m, f"no {pattern!r} in csrc/{source}"
    return int(m.group(1))


# ------------------------------------------------------------- onehot_count

# csrc/probe_units.cu's geometry: a block step covers COUNT_WARPS x
# COUNT_ROWS rows, up to COUNT_CLUSTER blocks split the rows
COUNT_WARPS, COUNT_ROWS, COUNT_CLUSTER = (
    _cu_int("probe_units.cu", rf"constexpr int {n} = (\d+);")
    for n in ("kCountWarps", "kCountRows", "kCountCluster"))


def onehot_count_slices(c: torch.Tensor, warps: int = COUNT_WARPS, rows: int = COUNT_ROWS,
                        cluster: int = COUNT_CLUSTER, half: bool = True,
                        twice: bool = False) -> torch.Tensor:
    """The kernel's decomposition in torch: the rows split over ``split =
    min(cluster, ceil(LB / (warps * rows)))`` ranks, rank r taking the
    steps r, r + split, ... of ``warps * rows`` rows; each rank's slice
    counted by 256 compares a byte (in fp16, bytes and keys converted, where
    ``half``), the ranks' partials summed.  ``twice`` counts rank 0's slice
    twice (a mutation the tests tell apart)."""
    LB, TB = c.shape
    step = warps * rows
    split = min(cluster, max(1, -(-LB // step)))
    keys = torch.arange(256, dtype=torch.int32)
    x, k = (c.to(torch.float16), keys.to(torch.float16)) if half else (c, keys)
    total = torch.zeros(TB, dtype=torch.int32)
    for rank in range(split):
        idx = [i for i0 in range(rank * step, LB, split * step)
               for i in range(i0, min(i0 + step, LB))]
        part = (x[idx][:, :, None] == k).sum((0, 2), dtype=torch.int32)
        total += part * (2 if twice and rank == 0 else 1)
    return total.unsqueeze(0)


# (LB, TB): rows that no step divides, a ragged column tile, one row, none
COUNT_SHAPES = [(100, 40), (33, 130), (1, 16), (0, 8)]
# (warps, rows, cluster): the kernel's, and small ones that split 100 rows
# into uneven slices (step 6: 17 steps over 4 ranks; step 8 over 8)
SPLITS = [(COUNT_WARPS, COUNT_ROWS, COUNT_CLUSTER), (2, 3, 4), (4, 2, 8)]


def _c(LB, TB, seed):
    return np.random.default_rng(seed).integers(-300, 600, size=(LB, TB)).astype(np.int32)


@pytest.fixture(scope="module")
def k4_outs():
    """probe_tpu2.py's F on each shape's bytes (values outside [0, 256)
    too): (c, output); LB = 0 has no probe run (its fori_loop is empty, the
    output zeros)."""
    k4 = _load("probe_tpu2.py", "k4")
    out = {}
    for LB, TB in COUNT_SHAPES:
        c = _c(LB, TB, seed=LB + TB)
        out[(LB, TB)] = (c, _call(k4, _i32(1, TB), c) if LB else np.zeros((1, TB), np.int32))
    return out


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", COUNT_SHAPES)
def test_onehot_count_slices_equal_f(k4_outs, shape, split, half):
    c, want = k4_outs[shape]
    got = onehot_count_slices(torch.from_numpy(c), *split, half=half)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p2.onehot_count_plain(torch.from_numpy(c)))
    if shape[0] > 1:
        assert 0 < want.min() and want.max() < shape[0]  # not trivially 0 or LB


def test_onehot_count_slice_twice_is_told_apart(k4_outs):
    c, want = k4_outs[(100, 40)]
    for split in SPLITS[1:]:
        got = onehot_count_slices(torch.from_numpy(c), *split, twice=True)
        assert not np.array_equal(got.numpy(), want)


def test_half_compare_is_exact_on_int32_edges():
    """Each int32 converts to fp16 (round to nearest even) as a value in
    0..255 exactly when it is that value: every int in [-4096, 4096] and
    the edges of fp16's exact range, its largest finite value, its
    overflow to infinity and int32's ends; numpy's and torch's conversions
    both, and the twin's half form against the int32 count on them."""
    edges = [-2**31, -2**31 + 1, -2**24 - 1, -65536, -65520, -65519, -65505, -65504, -32769,
             -8193, 8193, 32769, 65504, 65505, 65519, 65520, 65536, 2**24 + 1, 2**31 - 2,
             2**31 - 1]
    v = np.concatenate([np.arange(-4096, 4097), edges]).astype(np.int32)
    keys = np.arange(256)
    with np.errstate(over="ignore"):
        for h in (v.astype(np.float16),
                  torch.from_numpy(v).to(torch.float16).numpy()):
            hits = (h[:, None] == keys.astype(np.float16)).sum(1)
            assert np.array_equal(hits, ((v >= 0) & (v < 256)).astype(int))
            inside = (v >= 0) & (v < 256)
            assert np.array_equal(h[inside].astype(np.int64), v[inside])
    c = torch.from_numpy(np.resize(v, (len(v) // 64 + 1) * 64).reshape(-1, 64))
    assert torch.equal(onehot_count_slices(c, half=True), p2.onehot_count_plain(c))


# ---------------------------------------------------------------- mma_accum

# csrc/probe_mma_accum.cu's geometry: a block's tile of TILE_M rows and
# TILE_N columns, TILE_N_WIDE where N > WIDE_PAST; k a stage TILE_K
TILE_M = _cu_int("probe_mma_accum.cu", r"constexpr int kBM = (\d+);")
TILE_K = _cu_int("probe_mma_accum.cu", r"constexpr int kBK = (\d+);")
WIDE_PAST = _cu_int("probe_mma_accum.cu", r"const bool wide = N > (\d+);")
TILE_N_WIDE = _cu_int("probe_mma_accum.cu", r"return wide \? launch<(\d+)>")
TILE_N = _cu_int("probe_mma_accum.cu", r"\s: launch<(\d+)>")


def tile_n(N: int) -> int:
    """The kernel's tile width for ``N`` columns."""
    return TILE_N_WIDE if N > WIDE_PAST else TILE_N


def mma_accum_tiles(a: torch.Tensor, b: torch.Tensor, tm: int = TILE_M, tn=None,
                    tk: int = TILE_K, reset: bool = False) -> torch.Tensor:
    """The kernel's tile walk in torch: for each i and each ``tm`` x ``tn``
    tile (``tn`` the kernel's ``tile_n(N)`` by default; tiles may hang past
    M and N), one f32 accumulator carried over every l, fed by [tm, tk]
    boxes of a and [tk, tn] boxes of b zero-filled past the matrix's own
    rows, columns and K, and stored at each l clipped to the matrix.
    ``reset`` zeroes the accumulator at each l (a mutation the tests tell
    apart)."""
    NI, NL, M, K, N = p21._check(a, b)
    tn = tn or tile_n(N)
    out = torch.empty((NI, NL, M, N), dtype=torch.float32)
    for i in range(NI):
        for m0 in range(0, M, tm):
            for n0 in range(0, N, tn):
                rows, cols = min(tm, M - m0), min(tn, N - n0)
                acc = torch.zeros((tm, tn), dtype=torch.float32)
                for l in range(NL):
                    if reset:
                        acc = torch.zeros_like(acc)
                    for k0 in range(0, K, tk):
                        ks = min(tk, K - k0)
                        A = torch.zeros((tm, tk), dtype=torch.float32)
                        B = torch.zeros((tk, tn), dtype=torch.float32)
                        A[:rows, :ks] = a[i, l, m0:m0 + rows, k0:k0 + ks].float()
                        B[:ks, :cols] = b[i, l, k0:k0 + ks, n0:n0 + cols].float()
                        acc = acc + A @ B
                    out[i, l, m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out


# [NI, NL, M, K] (b [NI, NL, K, M]): the probe's, M and N under a tile,
# over one by half a tile, K under a k box and K over two boxes by half
MM_SHAPES = [p21.SHAPE, (1, 3, 192, 96), (2, 1, 64, 32), (1, 2, 320, 64)]


def _mm_probe(a, b):
    """probe_tpu21.py's D body at a's and b's shapes: grid (NI, NL), a
    [1, 1, M, K] block of a, [1, 1, K, N] of b and the output, f32 scratch
    [M, N], as its script's call (:112-125) at [4, 2, 128, 128]."""
    NI, NL, M, K, N = p21._check(a, b)
    call = _Interpret.pallas_call(
        _load("probe_tpu21.py", "mm_kern"), grid=(NI, NL),
        in_specs=[_spec((1, 1, M, K), lambda i, l: (i, l, 0, 0)),
                  _spec((1, 1, K, N), lambda i, l: (i, l, 0, 0))],
        out_specs=_spec((1, 1, M, N), lambda i, l: (i, l, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((NI, NL, M, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((M, N), jnp.float32)])
    fa, fb = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (a, b))
    return np.asarray(call(fa, fb))


@pytest.fixture(scope="module")
def mm_outs():
    """The probe's D on each shape and kind, and on an N != M case with b
    built directly: {(shape, kind): (a, b, output)}."""
    out = {}
    for shape in MM_SHAPES:
        for kind in ("ints", "normal"):
            a, b = p21.inputs(shape, kind, seed=shape[2] + shape[3])
            out[(shape, kind)] = (a, b, _mm_probe(a, b))
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-8, 9, size=(2, 3, 64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 9, size=(2, 3, 96, 192)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out[("n_ne_m", "ints")] = (a, b, _mm_probe(a, b))
    return out


@pytest.mark.parametrize("tiles", [(TILE_M, None, TILE_K),
                                   (TILE_M, TILE_N, TILE_K), (64, 128, 32)])
@pytest.mark.parametrize("key", [(s, k) for s in MM_SHAPES for k in ("ints", "normal")]
                         + [("n_ne_m", "ints")])
def test_mma_accum_tiles_equal_d(mm_outs, key, tiles):
    a, b, want = mm_outs[key]
    got = mma_accum_tiles(a, b, *tiles)
    plain = p21.mma_accum_plain(a, b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if key[1] == "ints":
        assert np.array_equal(got.numpy(), want) and torch.equal(got, plain)
    else:
        tol = p21.tolerance(a, b).numpy()
        assert (np.abs(got.numpy() - want) <= tol).all()
        assert (got - plain).abs().le(p21.tolerance(a, b)).all()


def test_mma_accum_reset_is_told_apart(mm_outs):
    for shape in MM_SHAPES:
        a, b, want = mm_outs[(shape, "ints")]
        got = mma_accum_tiles(a, b, reset=True)
        assert shape[1] == 1 or not np.array_equal(got.numpy(), want)
        assert np.array_equal(got[:, 0].numpy(), want[:, 0])  # l = 0 is the same


@pytest.mark.parametrize("NI,NL,M,K,N", [(2, 3, 128, 64, 256), (1, 2, 256, 96, 64),
                                         (3, 2, 64, 128, 192)])
def test_mma_accum_tiles_equal_plain_n_ne_m(NI, NL, M, K, N):
    """The card test's N != M inputs (test_torch_cuda.py's
    ``test_probe_mma_accum_n_ne_m``, integers in [-8, 8]): the tile walk
    equals the plain version exactly, so the kernel's equality to the
    plain version there is its equality to the tile walk."""
    rng = np.random.default_rng(M + N)
    a, b = (torch.from_numpy(rng.integers(-8, 9, size=s).astype(np.float32))
            .to(torch.bfloat16) for s in ((NI, NL, M, K), (NI, NL, K, N)))
    assert torch.equal(mma_accum_tiles(a, b), p21.mma_accum_plain(a, b))


# ----------------------------------------------------------------- int8_mma

# csrc/probe_int8_mma.cu's geometry: K padded to KPAD in the staged copies;
# a tile's TILE8_M rows, TILE8_N columns (TILE8_N_WIDE where N >
# WIDE8_PAST); k a stage TILE8_K bytes, in SLICE8 slices (wgmma's k32)
KPAD = _cu_int("probe_int8_mma.cu", r"constexpr int kPad = (\d+);")
TILE8_M = _cu_int("probe_int8_mma.cu", r"constexpr int kBM = (\d+);")
TILE8_K = _cu_int("probe_int8_mma.cu", r"constexpr int kBK = (\d+);")
SLICE8 = _cu_int("probe_int8_mma.cu", r"for \(int kk = 0; kk < kBK / (\d+); \+\+kk\)")
WIDE8_PAST = _cu_int("probe_int8_mma.cu", r"const bool wide = N > (\d+);")
TILE8_N_WIDE = _cu_int("probe_int8_mma.cu", r"return wide \? launch<(\d+)>")
TILE8_N = _cu_int("probe_int8_mma.cu", r"\s: launch<(\d+)>\(ma")
SMS = 132  # the H100 SXM's SMs: the persistent grid's blocks at most


def int8_mma_tiles(a: torch.Tensor, b: torch.Tensor, sms: int = SMS, in_place=None,
                   shift: int = 0) -> torch.Tensor:
    """The kernel's decomposition in torch: the staging pass (b^T [N, Kp]
    zero-padded; a copied to [M, Kp] unless ``in_place``, by default where
    K is a multiple of KPAD), then ``min(tiles, sms)`` persistent blocks,
    block i taking tiles i, i + sms, ... (m varying fastest), each tile's
    k stages of TILE8_K split into SLICE8 slices read from the staged
    copies (zeros past M, N and Kp), the sums in int32 that wrap.
    ``shift`` reads every k slice that many bytes further (a mutation the
    tests tell apart)."""
    M, N, K = p17._check(a, b)
    Kp = -(-K // KPAD) * KPAD
    bt = torch.zeros((N, Kp), dtype=torch.int64)
    bt[:, :K] = b.t().long()
    in_place = K % KPAD == 0 if in_place is None else in_place
    ak = a.long() if in_place else torch.cat([a.long(), torch.zeros((M, Kp - K), dtype=torch.int64)], 1)
    tm, tn = TILE8_M, TILE8_N_WIDE if N > WIDE8_PAST else TILE8_N
    mt, nt = -(-M // tm), -(-N // tn)
    kb = -(-K // TILE8_K)

    def box(x, r0, rows, k0):  # [rows, SLICE8] at (r0, k0), zeros outside x
        out = torch.zeros((rows, SLICE8), dtype=torch.int64)
        r1, k1 = min(r0 + rows, x.shape[0]), min(max(k0, 0) + SLICE8, x.shape[1])
        if k0 < x.shape[1]:
            out[: r1 - r0, : k1 - k0] = x[r0:r1, k0:k1]
        return out

    c = torch.empty((M, N), dtype=torch.int32)
    for blk in range(min(mt * nt, sms)):
        for tile in range(blk, mt * nt, sms):
            m0, n0 = tile % mt * tm, tile // mt * tn
            acc = torch.zeros((tm, tn), dtype=torch.int64)
            for s in range(kb):
                for kk in range(TILE8_K // SLICE8):
                    k0 = s * TILE8_K + kk * SLICE8 + shift
                    acc += box(ak, m0, tm, k0) @ box(bt, n0, tn, k0).t()
            acc = (acc + 2**31) % 2**32 - 2**31  # int32 that wraps
            rows, cols = min(tm, M - m0), min(tn, N - n0)
            c[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols].to(torch.int32)
    return c


# (M, N, K, ranges): the probe's 128^3, the table test's ragged int8 case,
# N past one wide tile, K over one stage and not a multiple of 16, one row
INT8_SHAPES = [(128, 128, 128, "probe"), (48, 96, 40, "int8"), (130, 300, 129, "int8"),
               (64, 257, 272, "int8"), (1, 3, 5, "int8")]


@pytest.fixture(scope="module")
def k_outs():
    """probe_tpu17.py's k on each shape: (a, b, output); the int8 cases
    carry -128 and 127 in a's first row and b's first column."""
    out = {}
    for M, N, K, ranges in INT8_SHAPES:
        a, b = (t.numpy() for t in p17.inputs(M, N, K, seed=M + N, probe=ranges == "probe"))
        if ranges == "int8":
            a[0, :4] = [-128, 127, -128, 127][: min(4, K)]
            b[: min(4, K), 0] = [-128, -128, 127, 127][: min(4, K)]
        out[(M, N, K)] = (a, b, _call(_load("probe_tpu17.py", "k"), _i32(M, N), a, b))
    return out


@pytest.mark.parametrize("sms", [SMS, 1, 3])
@pytest.mark.parametrize("shape", [s[:3] for s in INT8_SHAPES])
def test_int8_mma_tiles_equal_k(k_outs, shape, sms):
    a, b, want = k_outs[shape]
    got = int8_mma_tiles(_t(a), _t(b), sms=sms)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p17.int8_mma_plain(_t(a), _t(b)))
    # a staged or read in place: the same sums
    assert torch.equal(int8_mma_tiles(_t(a), _t(b), in_place=False), got)


def test_int8_mma_tiles_exact_at_max_k():
    """At the wrapper's MAX_K the largest sums (-128 x -128 in every term,
    and -128 x 127) stay inside int32: the twin's int32 equals the exact
    sum."""
    K = p17.MAX_K
    a = torch.full((2, K), -128, dtype=torch.int8)
    b = torch.full((K, 3), -128, dtype=torch.int8)
    b[:, 1] = 127
    want = torch.tensor([K * 2**14, -K * 128 * 127, K * 2**14], dtype=torch.int64)
    assert K * 2**14 < 2**31
    assert torch.equal(int8_mma_tiles(a, b), want.expand(2, 3).to(torch.int32))


def test_int8_mma_slice_shift_is_told_apart(k_outs):
    for shape in [s[:3] for s in INT8_SHAPES[:4]]:
        a, b, want = k_outs[shape]
        assert not np.array_equal(int8_mma_tiles(_t(a), _t(b), shift=1).numpy(), want)


# ----------------------------------------------------------------- dfa_step

# csrc/probe_dfa_step.cu's lookup: a block's warps at most (time-major;
# batch-major three quarters of them), a group's steps, a warp's ring of
# groups
LK_WARPS, LK_STEP, LK_RING = (_cu_int("probe_dfa_step.cu", rf"constexpr int {n} = (\d+);")
                              for n in ("kLkWarps", "kLkStep", "kLkRing"))


def dfa_lookup_tiles(T: torch.Tensor, chars: torch.Tensor, time_major: bool = False,
                     sms: int = 132, stale: bool = False) -> torch.Tensor:
    """The lookup kernel's walk in torch: tiles of 32 strings (a lane a
    string); each warp walks the same number of tiles (rounds: the fewest
    that ``sms`` blocks of at most LK_WARPS warps allow), the grid's warp g
    tiles g, g + its warps, ... from s = 0.  Group p (steps
    LK_STEP p ..) is copied into ring slot p % LK_RING as the [steps,
    strings] tile, only the words inside [TB] x [LB]; the walk reads every
    lane's byte from the slot (stale words for strings past TB or steps
    past LB, whose states are never stored), one lookup T[c & 255, s] a
    step, and stores the inside words of the group's staged states.
    ``stale``: each group's first lookup takes the state two steps back (a
    mutation the tests tell apart)."""
    p1._check_dfa(T, chars, "lookup", "gather", None)
    c = (chars if time_major else chars.t()).long()  # [LB, TB]
    LB, TB = c.shape
    tab = T.reshape(-1).long()  # staged as it is: rows of 128 words
    out = torch.full((LB, TB), -1, dtype=torch.int32)
    n_tiles, n_groups = -(-TB // 32), -(-LB // LK_STEP)
    most = LK_WARPS if time_major else LK_WARPS * 3 // 4
    rounds = -(-n_tiles // (sms * most))
    warps = -(-n_tiles // (sms * rounds))
    grid = -(-n_tiles // (warps * rounds)) * warps  # the grid's warps
    ring = torch.zeros((LK_RING, LK_STEP, 32), dtype=torch.int64)  # [slot][step][lane]
    for g in range(grid):
        for tile in range(g, n_tiles, grid):
            b = tile * 32 + torch.arange(32)
            s = torch.zeros(32, dtype=torch.int64)
            back = s  # the state two steps back
            for p in range(n_groups):
                slot = ring[p % LK_RING]
                i = LK_STEP * p + torch.arange(LK_STEP)[:, None]
                ok = (b[None, :] < TB) & (i < LB)
                slot[ok] = c[i.expand(-1, 32)[ok], b.expand(LK_STEP, -1)[ok]]
                for j in range(LK_STEP):
                    prev = back if stale and j == 0 and p > 0 else s
                    back, s = s, tab[(slot[j] & 255) * p1.NS + prev]
                    if LK_STEP * p + j < LB:
                        out[LK_STEP * p + j, b[b < TB]] = s[b < TB].to(torch.int32)
    return out if time_major else out.t().contiguous()


@pytest.mark.parametrize("tm", [False, True])
@pytest.mark.parametrize("sms", [1, 132])
def test_dfa_lookup_tiles_equal_k7(scans, tm, sms):
    """k7's output (batch-major, interpret mode) by the lookup's
    decomposition, in either layout (the time-major input is k7's bytes
    transposed)."""
    T, c, form, _tm, _pick, _cl, want = scans["k7"]
    assert form == "lookup" and not _tm
    chars = _t(c).t().contiguous() if tm else _t(c)
    got = dfa_lookup_tiles(_t(T), chars, tm, sms)
    got = got.t() if tm else got
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p1.dfa_step_plain(_t(T), _t(c)))


@pytest.mark.parametrize("tm", [False, True])
@pytest.mark.parametrize("TB,LB,sms", [(37, 13, 132), (100, 21, 132), (300, 9, 132),
                                       (32 * 17 + 5, 6, 2), (64, LK_STEP * (LK_RING + 2) + 3, 1)])
def test_dfa_lookup_tiles_ragged(TB, LB, sms, tm):
    """Strings past TB in a warp's 32 (37, 100, 300), steps past LB in a
    group (13, 21, 9, 6), more tiles than the grid's warps (18 tiles on 2
    blocks: a warp walks 2), and more groups than the ring holds."""
    shape = (LB, TB) if tm else (TB, LB)
    c = p1.bytes_(*shape, seed=TB + LB)
    T = p1.table(seed=TB)
    assert torch.equal(dfa_lookup_tiles(T, c, tm, sms), p1.dfa_step_plain(T, c, "lookup", tm))


def test_dfa_lookup_stale_group_start_is_told_apart(scans):
    T, c, _form, _tm, _pick, _cl, want = scans["k7"]
    assert not np.array_equal(dfa_lookup_tiles(_t(T), _t(c), stale=True).numpy(), want)


# csrc/probe_dfa_step.cu's geometry for the products: a warp's strings, a
# block's warps (two warpgroups of four), a ring group's steps (even: the
# two accumulators alternate with the step's parity)
DFA_WARP_STRINGS = _cu_int("probe_dfa_step.cu", r"constexpr int STRINGS = (\d+);")
DFA_WARPS = _cu_int("probe_dfa_step.cu", r"constexpr int WARPS = (\d+);")
DFA_GROUP = _cu_int("probe_dfa_step.cu", r"constexpr int GROUP = (\d+);")
# steps from a position's bytes to its pick (one-hot, class forms)
DFA_LAG = {form: _cu_int("probe_dfa_step.cu",
                         r"LAG = FORM == ONEHOT_MMA \? " + pat + r";")
           for form, pat in (("onehot_mma", r"(\d+) : \d+"), ("class_mma", r"\d+ : (\d+)"))}
WG_ROWS = 4 * DFA_WARP_STRINGS  # wgmma's M: a warpgroup's strings


def onehot_half2(c: torch.Tensor) -> torch.Tensor:
    """The one-hot [R, 256] of bytes c [R] as the kernel builds it: column
    k = 16 kt + kk (k16 slice kt) is held by the thread of column pair q =
    (kk % 8) // 2 as half e = kk % 2 of its register for kk < 8 (kk >= 8:
    the next register); the byte less 2 q + e on fp16, compared with 16 kt
    + 8 (kk // 8): 1.0 or 0.0 in fp16."""
    k = torch.arange(p1.NB)
    kt, kk = k // 16, k % 16
    sub = (2 * ((kk % 8) // 2) + kk % 2).to(torch.float16)
    key = (16 * kt + 8 * (kk // 8)).to(torch.float16)
    x = c.to(torch.float16)[:, None] - sub[None, :]
    return (x == key[None, :]).to(torch.float16)


def dfa_step_warpgroups(T: torch.Tensor, chars: torch.Tensor, form: str = "onehot_mma",
                        time_major: bool = False, pick: str = "gather",
                        classes=None, late: bool = False) -> torch.Tensor:
    """The kernel's product forms in torch: rows of WG_ROWS strings (strings
    past TB padded with byte 0, never stored); step t issues position t's
    products of the one-hot of the row's bytes (``onehot_half2``): times T
    into acc[t % 2] (f32 sums), or times C into the class sums (one sum
    over the k16 slices in order), which, converted to f16, times Tk
    padded to 16 rows is issued at step t + 1 into acc[t % 2]; then it
    picks position t - LAG (one-hot 1, class 2) from acc[(t - LAG) % 2],
    column s of each row by ``pick`` (gather:
    the sums, column s taken as int32; sum: the sums masked by column ==
    s, summed); LAG more steps after the last position.  ``late`` picks
    from the other accumulator, the position after its own (a mutation
    the tests tell apart)."""
    assert DFA_GROUP % 2 == 0 and WG_ROWS == 64 and DFA_WARPS % 4 == 0
    p1._check_dfa(T, chars, form, pick, classes)
    c = (chars if time_major else chars.t()).long()  # [LB, TB]
    LB, TB = c.shape
    if form == "class_mma":
        C = torch.zeros((p1.NB, p1.KC), dtype=torch.float16)
        C[torch.arange(p1.NB), classes.long()] = 1
        Tk = torch.zeros((p1.KC, p1.NS), dtype=torch.float16)
        Tk[: T.shape[0]] = T.to(torch.float16)
    else:
        Tf = T.to(torch.float16)
    out = torch.empty((LB, TB), dtype=torch.int32)
    cols = torch.arange(p1.NS)
    for r0 in range(0, TB, WG_ROWS):
        rows = min(WG_ROWS, TB - r0)
        cr = torch.zeros((LB, WG_ROWS), dtype=torch.int64)
        cr[:, :rows] = c[:, r0:r0 + rows]
        acc = [torch.zeros((WG_ROWS, p1.NS)), torch.zeros((WG_ROWS, p1.NS))]
        kacc = torch.zeros((WG_ROWS, p1.KC))
        s = torch.zeros(WG_ROWS, dtype=torch.int64)
        lag = DFA_LAG[form]

        def pick_from(d, t):
            nonlocal s
            if pick == "gather":
                s = d.gather(1, s[:, None])[:, 0].to(torch.int32).long()
            else:
                s = (d * (cols[None, :] == s[:, None])).sum(1).long()
            out[t, r0:r0 + rows] = s[:rows].to(torch.int32)

        for t in range(LB + lag):
            if form == "class_mma" and 1 <= t <= LB:  # t - 1's last product
                acc[(t - 1) % 2] = kacc.to(torch.float16).float() @ Tk.float()
            if t < LB:
                A = onehot_half2(cr[t]).float()
                if form == "onehot_mma":
                    acc[t % 2] = A @ Tf.float()
                else:
                    kacc = sum(A[:, 16 * kt:16 * kt + 16] @ C[16 * kt:16 * kt + 16].float()
                               for kt in range(p1.NB // 16))
            if t >= lag:
                pick_from(acc[(t - lag + late) % 2], t - lag)
    return out if time_major else out.t().contiguous()


DFA_PROBES = ["k6", "k7", "C", "D", "make_scan_fullwidth", "make_scan_select"]


@pytest.mark.parametrize("pick", ["gather", "sum"])
@pytest.mark.parametrize("name", DFA_PROBES)
def test_dfa_step_warpgroups_equal_probe(scans, name, pick):
    """Each DFA-step probe's output by the product forms' decomposition
    (k7, the lookup, by the one-hot product: every form is one function)."""
    T, c, form, tm, _pick, classes, want = scans[name]
    form = "onehot_mma" if form == "lookup" else form
    cl = None if classes is None else _t(classes)
    got = dfa_step_warpgroups(_t(T), _t(c), form, tm, pick, cl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p1.dfa_step_plain(_t(T), _t(c), form, tm, pick, cl))


@pytest.mark.parametrize("form", ["onehot_mma", "class_mma"])
@pytest.mark.parametrize("TB,LB,tm", [(100, 21, True), (37, 13, False), (130, 8, True)])
def test_dfa_step_warpgroups_ragged(form, TB, LB, tm):
    """Rows of 64 cut short (37, 100, 130 strings), steps that fill no ring
    group (13, 21) or one exactly (8); class_mma with K = 5 classes."""
    shape = (LB, TB) if tm else (TB, LB)
    c = p1.bytes_(*shape, seed=TB + LB)
    classes, T = None, p1.table(seed=TB)
    if form == "class_mma":
        classes, T = p2.class_inputs(seed=LB)
        classes, T = classes % 5, T[:5].contiguous()
    want = p1.dfa_step_plain(T, c, form, tm, "gather", classes)
    for pick in ("gather", "sum"):
        assert torch.equal(dfa_step_warpgroups(T, c, form, tm, pick, classes), want), pick


def test_onehot_half2_is_the_one_hot():
    """The half2 compares give the one-hot exactly for every byte (and no
    1.0 for values outside [0, 256), as garbage bytes past TB may be)."""
    c = torch.arange(-300, 600)
    got = onehot_half2(c)
    want = (c[:, None] == torch.arange(p1.NB)[None, :]).to(torch.float16)
    assert torch.equal(got, want)


def test_dfa_step_late_pick_is_told_apart(scans):
    for name in ("k6", "C", "D", "make_scan_select"):
        T, c, form, tm, pick, classes, want = scans[name]
        cl = None if classes is None else _t(classes)
        got = dfa_step_warpgroups(_t(T), _t(c), form, tm, pick, cl, late=True)
        assert not np.array_equal(got.numpy(), want), name
