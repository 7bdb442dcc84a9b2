"""The redesigned onehot_count and mma_accum kernels' decompositions, as
torch twins, against the probes themselves and the plain versions.

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

The twins' geometry is read from the kernels' sources (``csrc/``), so a
change there is a change here.  Each twin has one mutation (a slice
counted twice; the accumulator reset at each l) that the probe's output
tells apart, and the half2 form's claim (every int32 converts to fp16 as
a value in 0..255 only if it is that value) is checked on the int32
edges.  The kernels themselves run only on the card
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
from halo2_regex_tpu_torch.probes import probe_tpu2 as p2
from halo2_regex_tpu_torch.probes import probe_tpu21 as p21

from test_torch_probes import _Interpret, _load, _spec
from test_torch_probes_table import _call, _i32



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
