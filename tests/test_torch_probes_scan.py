"""The chunked forms of loop_floor and the slab kernel, as torch twins,
against their plain versions and the probes themselves.

``csrc/probe_tpu9.cu``'s ``floor_chunk_kernel`` and ``csrc/probe_slab.cuh``'s
``slab_chunk_kernel`` scan tiles of rows (positions) and join them by a
decoupled look-back.  Their twins in ``halo2_regex_tpu_torch.probes.probe_tpu9``
compute what they compute, phase by phase:

- ``loop_floor_chunks_plain(x, C)``: each tile's sums, an exclusive prefix
  over the tiles, each tile's running sum plus its prefix;
- ``slab_chunks_plain(tk, classes, x, first, n_out, C, n_sub, depth)``:
  each chunk's map over every start state and the states at its sub-chunk
  starts (``slab_chunk_maps``), the maps composed in chunk order from
  ``first`` with the look-back reading ``depth`` maps back before it meets
  an end state (``slab_chunk_starts``), and the replay from the recorded
  states (``slab_chunk_replay``).

Each twin must equal its plain version bit for bit, and through it the
TPU kernels run in interpret mode (``_load`` of tests/test_torch_probes.py):
probe_tpu9's ``ka``, ``kb`` and ``kc`` and probe_tpu18's ``build``.  Cases:
L not a multiple of C and L < C, TB not a multiple of 32, S = 1, 24 and 32,
``first`` other than 0, bytes outside [0, 256), sums that wrap at 2^31, and
a permutation table (no two start states ever merge).  Three mutations of
the slab twin must be told apart from the plain version.  Then the form
rule, the chunk rule, the look-back scratch's epochs and the wrappers'
``form`` checks, on the CPU.  The kernels run only on the card
(tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from halo2_regex_tpu_torch.ops import kernels
from halo2_regex_tpu_torch.probes import probe_tpu9 as p9
from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

from test_torch_probes import VMEM, _load, _t, _terms
from test_torch_probes_table import slabs  # noqa: F401  (the fixture: build's outputs)


def _floor_probe(probe: str, x: np.ndarray) -> np.ndarray:
    L, TB = x.shape
    kern = _load("probe_tpu9.py", probe, L=L, TB=TB, SB=8)
    run = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((L, TB), jnp.int32),
                         in_specs=[VMEM], out_specs=VMEM, interpret=True)
    return np.asarray(run(jnp.asarray(x)))


def _kc(tk: np.ndarray, classes: np.ndarray, x: np.ndarray):
    L, TB = x.shape
    terms, cls0 = _terms(classes)
    kern = _load("probe_tpu9.py", "kc", L=L, TB=TB, SB=8, S=p9.S, K=p9.K, terms=terms,
                 cls0=cls0)
    run = pl.pallas_call(kern, out_shape=[jax.ShapeDtypeStruct((L, TB), jnp.int32)] * 4,
                         in_specs=[VMEM, VMEM], out_specs=[VMEM] * 4, interpret=True)
    return [np.asarray(o) for o in run(jnp.asarray(tk.astype(np.float32)), jnp.asarray(x))]


def _equal(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w), j


# ------------------------------------------------------------------ loop_floor


@pytest.mark.parametrize("values", ["bytes", "wrap"])
@pytest.mark.parametrize("L,TB,C", [(64, 16, 16), (72, 40, 32), (40, 33, 64), (128, 32, 24)])
@pytest.mark.parametrize("probe,slab", [("ka", 1), ("kb", 8)])
def test_floor_chunks_equal_probe(probe, slab, L, TB, C, values):
    """72 and 128 rows: not multiples of C; 40 rows: fewer than C; TB not a
    multiple of 32; "wrap": the sums pass 2^31."""
    rng = np.random.default_rng(L * TB + C)
    lo, hi = (0, 256) if values == "bytes" else (2**30, 2**31)
    x = rng.integers(lo, hi, size=(L, TB), dtype=np.int64).astype(np.int32)
    want = _floor_probe(probe, x)
    got = p9.loop_floor_chunks_plain(_t(x), C)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, p9.loop_floor_plain(_t(x), slab))
    if values == "wrap":
        assert (want < 0).any()  # the sums wrapped


def test_floor_chunks_mutation_is_told_apart():
    """An inclusive prefix over the tiles in place of the exclusive one."""
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (72, 40)).astype(np.int32))
    n, C = 3, 32
    tiles = torch.zeros((n * C, 40), dtype=torch.int64)
    tiles[:72] = x
    tiles = tiles.reshape(n, C, 40)
    inclusive = torch.cumsum(tiles.sum(1), 0)
    mutant = (torch.cumsum(tiles, 1) + inclusive[:, None]).reshape(n * C, 40)[:72]
    assert not torch.equal(mutant.to(torch.int32), p9.loop_floor_chunks_plain(x, C))


# ------------------------------------------------------------------------ slab


def _perm_table(K: int, S: int, seed: int) -> torch.Tensor:
    """A [K, 4S] table whose every column block is a permutation of the
    states: no two start states ever merge."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([np.concatenate([rng.permutation(S) for _ in range(4)])
                                      for _ in range(K)]).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _kc_case(L: int, TB: int):
    """kc's inputs at [L, TB] (bytes in [-300, 600)) and its four outputs,
    run once for every depth."""
    rng = np.random.default_rng(L + TB)
    classes = rng.integers(0, p9.K, size=256).astype(np.int32)
    tk = rng.integers(0, p9.S, size=(p9.K, 4 * p9.S)).astype(np.int32)
    x = rng.integers(-300, 600, size=(L, TB)).astype(np.int32)
    return tk, classes, x, _kc(tk, classes, x)


@pytest.mark.parametrize("depth", [None, 1, 3])
@pytest.mark.parametrize("L,TB,C", [(64, 16, 16), (72, 40, 32), (40, 33, 64)])
def test_slab_chunks_equal_kc(L, TB, C, depth):
    """kc's four outputs, bytes in [-300, 600): the twin at any look-back
    depth."""
    tk, classes, x, want = _kc_case(L, TB)
    got = p9.slab_chunks_plain(_t(tk), _t(classes), _t(x), 0, 4, C, depth=depth)
    _equal(got, want)
    _equal(got, p9.slab_plain(_t(tk), _t(classes), _t(x)))


@pytest.mark.parametrize("n_out", [1, 2, 4])
def test_slab_chunks_equal_build(slabs, n_out):  # noqa: F811
    """probe_tpu18's build (S = 24, from the model's first state) at C = 16
    and 24 (L = 64: not a multiple of 24)."""
    x, outs = slabs
    tab, classes, first = p18.slab_tables(
        p18.zoo.email_headers_model(max_chars_size=64, headers=("from",)))
    for C in (16, 24):
        _equal(p9.slab_chunks_plain(tab, classes, _t(x), first, n_out, C), outs[n_out])


@pytest.mark.parametrize("first", [5, 23])
def test_slab_chunks_from_other_states(slabs, first):  # noqa: F811
    """The from: table (S = 24) from states other than the model's first."""
    x, _outs = slabs
    tab, classes, _first = p18.slab_tables(
        p18.zoo.email_headers_model(max_chars_size=64, headers=("from",)))
    want = p18.slab_anatomy_plain(tab, classes, _t(x), first, 4)
    for depth in (None, 1):
        _equal(p9.slab_chunks_plain(tab, classes, _t(x), first, 4, 16, depth=depth), want)
    assert not torch.equal(want[0], p18.slab_anatomy_plain(tab, classes, _t(x), 0, 4)[0])


def test_slab_chunks_one_state():
    """S = 1: every map is the constant 0."""
    rng = np.random.default_rng(11)
    tk = torch.from_numpy(rng.integers(0, 1000, size=(6, 4)).astype(np.int32))
    tk[:, 0] = 0
    classes = torch.from_numpy(rng.integers(0, 6, size=256).astype(np.int32))
    x = torch.from_numpy(rng.integers(-10, 300, size=(48, 20)).astype(np.int32))
    _equal(p9.slab_chunks_plain(tk, classes, x, 0, 4, 16), p9.slab_plain(tk, classes, x, 0, 4))


@pytest.mark.parametrize("S", [24, 32])
def test_slab_chunks_permutation_table(S):
    """A DFA that never resyncs: every start state keeps its own walk, so
    a wrong start state shows at every position."""
    tk = _perm_table(8, S, seed=S)
    classes = torch.from_numpy(np.random.default_rng(S).integers(0, 8, 256).astype(np.int32))
    x = torch.from_numpy(np.random.default_rng(S + 1).integers(0, 256, (96, 40)).astype(np.int32))
    want = p9.slab_plain(tk, classes, x, 3, 4)
    for C, depth in ((16, None), (32, 1), (64, 2)):
        _equal(p9.slab_chunks_plain(tk, classes, x, 3, 4, C, depth=depth), want)


def test_slab_chunks_mutations_are_told_apart():
    """On a permutation table, each mutation differs from the plain
    version: the maps composed in reverse order (m o acc); chunk k started
    from m_k in place of m_{k-1}; every sub-chunk replayed from its
    chunk's start state."""
    S, C = 32, 16
    tk = _perm_table(8, S, seed=7)
    classes = torch.from_numpy(np.random.default_rng(7).integers(0, 8, 256).astype(np.int32))
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (96, 40)).astype(np.int32))
    want = p9.slab_plain(tk, classes, x, 0, 4)
    maps, marks = p9.slab_chunk_maps(tk, classes, x, C)

    def differs(starts, marks_=marks):
        got = p9.slab_chunk_replay(tk, classes, x, starts, marks_, 4, C)
        return not all(torch.equal(g, w) for g, w in zip(got, want))

    assert not differs(p9.slab_chunk_starts(maps, 0))  # the twin itself
    # reverse order: acc = m_k o acc
    reverse = [torch.zeros(40, dtype=torch.int64)]
    for r in range(1, maps.shape[0]):
        acc = torch.arange(S).expand(40, S)
        for k in range(r - 1, -1, -1):
            acc = torch.gather(maps[k], 1, acc)
        reverse.append(acc[:, 0])
    assert differs(torch.stack(reverse))
    # chunk k from m_k: start_k = m_k(start_{k-1})
    shifted = [torch.zeros(40, dtype=torch.int64)]
    for r in range(1, maps.shape[0]):
        shifted.append(torch.gather(maps[r], 1, shifted[-1][:, None])[:, 0])
    assert differs(torch.stack(shifted))
    # every sub-chunk from the chunk's start: the identity in place of the records
    ident = torch.arange(S).expand_as(marks).contiguous()
    assert differs(p9.slab_chunk_starts(maps, 0), ident)


# ------------------------------------------------------- forms, rules, scratch


def test_slab_form_rule():
    """The chunked form needs a warp to hold every start state (S <= 32)."""
    assert kernels.slab_form(1) == kernels.slab_form(32) == "chunked"
    assert kernels.slab_form(33) == kernels.slab_form(1008) == "serial"
    assert p9.scan_form(None) == "chunked" and p9.scan_form(None, 40) == "serial"
    assert p9.scan_form("serial", 40) == "serial"
    with pytest.raises(ValueError, match="S <= 32"):
        p9.scan_form("chunked", 33)
    with pytest.raises(ValueError, match="form"):
        p9.scan_form("tiled")


def test_scan_chunk_rule(monkeypatch):
    """512 or else 128 where its tiles are at least the SMs, else 64: the
    C that the library compiles."""
    monkeypatch.setattr(kernels, "_sms", lambda dev: 132)
    dev = torch.device("cpu")
    assert kernels.scan_chunk(65536, 64, dev) == 512  # 2 x 128 tiles
    assert kernels.scan_chunk(1024, 4096, dev) == 512  # 128 x 2
    assert kernels.scan_chunk(1024, 1024, dev) == 128  # 32 x 8; 32 x 4 are too few
    assert kernels.scan_chunk(1024, 256, dev) == 64
    assert kernels.scan_chunk(16, 8, dev) == 64
    assert kernels.scan_chunk(4104, 300, dev) == 128  # 10 x 9 at 512; 10 x 33
    assert kernels.scan_chunk(104, 3190, dev) == 64  # 100 x 1 at 128; 200 tiles at 64
    assert kernels.scan_chunk(200, 4300, dev) == 512  # 135 x 1: L < C
    assert set(kernels.SCAN_CHUNKS) == {64, 128, 512}


def test_lookback_scratch_epochs(monkeypatch):
    """One scratch a kernel, device and stream, zeros when made or grown,
    sized by the ticket and the kernel's bytes a tile; a new epoch each
    call; zeroed again when the epochs run out."""
    monkeypatch.setattr(kernels, "_stream", lambda t: 7)
    monkeypatch.setattr(kernels, "_index", lambda dev: 99)
    monkeypatch.setattr(kernels, "_LOOKBACK", {})
    monkeypatch.setattr(kernels, "LOOKBACK_EPOCHS", 4)
    t, fl = torch.zeros(1), kernels.LOOP_FLOOR
    key = (99, 7, fl.name)
    p1, e1 = kernels.lookback_scratch(fl, t, 2)
    p2, e2 = kernels.lookback_scratch(fl, t, 1)
    assert (p1, e1, e2) == (p2, 1, 2)  # the same scratch, the next epoch
    assert kernels._LOOKBACK[key][0].numel() == kernels.LOOKBACK_TICKET_BYTES + 2 * 32 * 8
    kernels._LOOKBACK[key][0].fill_(5)  # as a launch would leave it
    _p3, e3 = kernels.lookback_scratch(fl, t, 4)  # a larger grid: new zeros
    assert e3 == 1 and kernels._LOOKBACK[key][0].numel() == kernels.LOOKBACK_TICKET_BYTES + 4 * 256
    assert not kernels._LOOKBACK[key][0].any()
    assert [kernels.lookback_scratch(fl, t, 4)[1] for _ in range(2)] == [2, 3]
    kernels._LOOKBACK[key][0].fill_(5)
    _p4, e4 = kernels.lookback_scratch(fl, t, 4)  # the epochs ran out
    assert e4 == 1 and not kernels._LOOKBACK[key][0].any()
    # the slab kernels' scratches are their own, each tile a record of 1152
    # bytes: an address never holds a word of another layout
    for kern in (kernels.SLAB_SCAN, kernels.SLAB_ANATOMY):
        assert kernels.lookback_scratch(kern, t, 4)[1] == 1
        assert kernels._LOOKBACK[(99, 7, kern.name)][0].numel() == \
            kernels.LOOKBACK_TICKET_BYTES + 4 * 1152
    assert len(kernels._LOOKBACK) == 3


def test_lookback_layout_follows_the_source():
    """The scratch's sizes in ops/kernels.py are those of the sources: the
    ticket's bytes and the slab kernel's record (kRecordBytes)."""
    src = {name: (kernels.CSRC / name).read_text()
           for name in ("probe_lookback.cuh", "probe_slab.cuh")}
    assert f"constexpr int kTicketBytes = {kernels.LOOKBACK_TICKET_BYTES};" in \
        src["probe_lookback.cuh"]
    slab = src["probe_slab.cuh"]
    assert "constexpr int kMapBytes = 32 * 4 * 8;" in slab
    assert "constexpr int kRecordBytes = kMapBytes + 32 * 4;" in slab
    assert kernels.LOOKBACK_TILE_BYTES[kernels.SLAB_SCAN.name] == 32 * 4 * 8 + 32 * 4


def test_form_keyword_is_checked():
    x, classes, tk = p9.inputs(16, 8, seed=2)
    with pytest.raises(ValueError, match="form"):
        p9.loop_floor(x, 1, form="tiled")
    assert torch.equal(p9.loop_floor(x, 8, form="serial"), p9.loop_floor_plain(x, 8))
    assert all(torch.equal(a, b) for a, b in zip(p9.slab_scan(tk, classes, x, "chunked"),
                                                 p9.slab_scan_plain(tk, classes, x)))
    wide = torch.zeros((4, 4 * 40), dtype=torch.int32)  # S = 40
    cls = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="S <= 32"):
        p9.slab_scan(wide, cls, x, "chunked")
    assert len(p9.slab_scan(wide, cls, x)) == 4  # the rule: serial
    tab, classes18, first = p18.slab_tables(
        p18.zoo.email_headers_model(max_chars_size=16, headers=("from",)))
    with pytest.raises(ValueError, match="form"):
        p18.slab_anatomy(tab, classes18, p18.inputs(16, 8), first, 1, form="tiled")
    for call in (lambda: p9.loop_floor_cuda(x, 1, "chunked"),
                 lambda: p9.slab_scan_cuda(tk, classes, x, "serial"),
                 lambda: p18.slab_anatomy_cuda(tab, classes18, p18.inputs(16, 8), first, 2,
                                               "chunked")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
