"""The configs[3] table-step bisects' plain versions against the probes
themselves.

Each probe body is read from its script under ``tools/`` with ``ast``
(``_load`` of tests/test_torch_probes.py) at small free sizes and run by
``pallas_call`` in interpret mode: probe_tpu7's ``scan_kernel``,
probe_tpu28's ``try_variant``, probe_tpu31's and probe_tpu32's ``build``
whole (a recording ``pl`` keeps every call's inputs and outputs), the rest
with the grid and block specs their scripts give them.  The widened step
``probe_tpu28.dfa_wide_plain`` (and for k3 the slab kernel's
``slab_anatomy_plain``) must equal each bit for bit:

- probe_tpu6's k2 and k3;
- every case of probe_tpu7 (A-E) and of probe_tpu31 (six (K, S));
- probe_tpu28's v1 (count) and v2 (hi/lo, ``c mod K``, ``s mod S``);
- probe_tpu30's w1, w2 from an entry state, and w3: two launches chained
  at the first's last row equal one (its ``chained`` as written, rows
  doubled by ``repeat(2, 0)``, is not the scan);
- probe_tpu32's a-f: c is not the integer scan (bf16 rounds its table,
  1006 and 1007 to 1008, a state past the last), d and f are.

The product form's twin, ``b_fragments``, is held to the table it packs,
and one mutation of the step's plain version differs from the probes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from halo2_regex_tpu_torch.probes import probe_tpu7 as p7
from halo2_regex_tpu_torch.probes import probe_tpu18 as p18
from halo2_regex_tpu_torch.probes import probe_tpu28 as p28
from halo2_regex_tpu_torch.probes import probe_tpu30 as p30
from halo2_regex_tpu_torch.probes import probe_tpu31 as p31
from halo2_regex_tpu_torch.probes import probe_tpu32 as p32

from test_torch_probes import _i32, _Interpret, _load, _spec, _t

TB, SLAB = 16, 8


class _Recording(_Interpret):
    """The interpret-mode ``pl`` that keeps each call's inputs and outputs
    (numpy) in ``calls``, for functions that return only a verdict."""

    calls: list = []

    @staticmethod
    def pallas_call(*args, **kw):
        call = _Interpret.pallas_call(*args, **kw)

        def run(*a):
            out = call(*a)
            _Recording.calls.append(([np.asarray(x) for x in a], np.asarray(out)))
            return out

        return run


class _NoJit:
    """``jax`` whose ``jit`` returns the function as it is, so that a
    recording ``pallas_call`` inside it sees arrays, not tracers."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(f):
        return f


def _recorded(fn, *args):
    """``fn(*args)`` and the calls it made."""
    _Recording.calls = []
    res = fn(*args)
    return res, list(_Recording.calls)


# ------------------------------------------------------------- probe_tpu6


def test_dfa_wide_equals_k2():
    LC, NL, S = 32, 2, 32
    rng = np.random.default_rng(2)
    T = rng.integers(0, S, size=(256, S)).astype(np.int32)
    x = rng.integers(0, 256, size=(LC * NL, TB)).astype(np.int32)
    kern = _load("probe_tpu6.py", "k2", TB=TB, LC=LC, S=S)
    want = np.asarray(_Interpret.pallas_call(
        kern, grid=(1, NL),
        in_specs=[_spec((256, S), lambda b, l: (0, 0)), _spec((LC, TB), lambda b, l: (l, b))],
        out_specs=_spec((LC, TB), lambda b, l: (l, b)), out_shape=_i32(LC * NL, TB),
        scratch_shapes=[pltpu.VMEM((1, TB), jnp.int32)])(jnp.asarray(T), jnp.asarray(x)))
    got = p28.dfa_wide_plain(p28.as_table(T), _t(x))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p28.dfa_wide(p28.as_table(T), _t(x), form="onehot_mma"), got)
    assert len(np.unique(want)) > 8


def test_slab_second_output_equals_k3():
    """k3: the state P4[c, s], the output P4[c, S + s_prev]: the slab
    kernel's second output with the identity class map."""
    LC, NL, S = 32, 2, 32
    rng = np.random.default_rng(3)
    P4 = rng.integers(0, S, size=(256, 4 * S)).astype(np.int32)
    x = rng.integers(0, 256, size=(LC * NL, TB)).astype(np.int32)
    kern = _load("probe_tpu6.py", "k3", TB=TB, LC=LC, S=S)
    want = np.asarray(_Interpret.pallas_call(
        kern, grid=(1, NL),
        in_specs=[_spec((256, 4 * S), lambda b, l: (0, 0)),
                  _spec((LC, TB), lambda b, l: (l, b))],
        out_specs=_spec((LC, TB), lambda b, l: (l, b)), out_shape=_i32(LC * NL, TB),
        scratch_shapes=[pltpu.VMEM((1, TB), jnp.int32)])(jnp.asarray(P4), jnp.asarray(x)))
    ident = torch.arange(256, dtype=torch.int32)
    got = p18.slab_anatomy(_t(P4), ident, _t(x), 0, 2)[1]
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8


# ------------------------------------------------------------- probe_tpu7


@pytest.fixture(scope="module")
def tpu7_calls():
    """scan_kernel whole for each case, at TB = 16: its verdict and call."""
    scan = _load("probe_tpu7.py", "scan_kernel", TB=TB, LC=32, rng=np.random.default_rng(7),
                 np=np)
    scan.__globals__["pl"] = _Recording()
    return {name: _recorded(scan, *case) for name, case in p7.CASES.items()}


@pytest.mark.parametrize("name", list(p7.CASES))
def test_dfa_wide_equals_probe_tpu7(tpu7_calls, name):
    ok, calls = tpu7_calls[name]
    (T, x), want = calls[0]
    assert ok and len(calls) == 1
    got = p28.dfa_wide_plain(p28.as_table(T), _t(x))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.shape == (64 if p7.CASES[name][2] else 32, TB) and len(np.unique(want)) > 8


# ------------------------------------------------------------ probe_tpu28


@pytest.fixture(scope="module")
def tpu28_calls():
    """v1 and v2 through try_variant whole: K = 96, S = 1008, 2 chunks of
    32 positions, chars in [32, 127)."""
    K, S, LCC, NL = 96, 1008, 32, 2
    rng = np.random.default_rng(28)
    tbl = rng.integers(0, 256, size=(K, 2 * S)).astype(np.float32)
    chars = rng.integers(32, 127, size=(LCC * NL, TB)).astype(np.int32)
    free = dict(TB=TB, S=S, K=K, LCC=LCC, NL=NL, L=LCC * NL, SLAB=SLAB, tbl_np=tbl,
                chars_np=chars, np=np)
    try_variant = _load("probe_tpu28.py", "try_variant", jax=_NoJit(), **free)
    try_variant.__globals__["pl"] = _Recording()
    out = {"tbl": tbl, "chars": chars}
    for name in ("v1", "v2"):
        kern = _load("probe_tpu28.py", name, **free)
        ok, calls = _recorded(try_variant, name, kern, [pltpu.VMEM((1, TB), jnp.int32)])
        assert ok and len(calls) == 1
        out[name] = calls[0][1]
    return out


def test_dfa_wide_count_equals_v1(tpu28_calls):
    t1 = p28.as_table(tpu28_calls["tbl"][:, :1008])
    got = p28.dfa_wide_plain(t1, _t(tpu28_calls["chars"]), cmod=True, form="count")
    assert np.array_equal(got.numpy(), tpu28_calls["v1"])


def test_dfa_wide_equals_v2(tpu28_calls):
    tbl, chars = p28.as_table(tpu28_calls["tbl"]), _t(tpu28_calls["chars"])
    got = p28.dfa_wide_plain(tbl, chars, hilo=True, cmod=True, smod=True)
    assert np.array_equal(got.numpy(), tpu28_calls["v2"])
    assert torch.equal(p28.dfa_wide(tbl, chars, True, True, True, form="onehot_mma"), got)
    assert len(np.unique(tpu28_calls["v2"])) > 8


# ------------------------------------------------------------ probe_tpu30


@pytest.fixture(scope="module")
def tpu30():
    """w1 over 4 chunks of 16 with its scratch, w2 over all L from an entry
    state, and ``chained`` as written, at K = 96, S = 1008, L = 64."""
    K, S, LCC, NL = 96, 1008, 16, 4
    L = LCC * NL
    tbl, chars, entry = p30.probe_inputs(L, TB, seed=30)
    tbl_j = jnp.asarray(tbl.float().numpy())  # the f32 table the probe passes (its values < 256)
    free = dict(TB=TB, S=S, K=K, LCC=LCC, L=L, SLAB=SLAB)
    body = _load("probe_tpu30.py", "body_common", **free)
    w1 = _load("probe_tpu30.py", "w1", body_common=body, **free)
    w2 = _load("probe_tpu30.py", "w2", body_common=body, **free)
    f1 = _Interpret.pallas_call(
        w1, grid=(NL,), in_specs=[_spec((K, 2 * S), lambda l: (0, 0)),
                                  _spec((LCC, TB), lambda l: (l, 0))],
        out_specs=_spec((LCC, TB), lambda l: (l, 0)), out_shape=_i32(L, TB),
        scratch_shapes=[pltpu.VMEM((1, TB), jnp.int32)])
    f2 = _Interpret.pallas_call(
        w2, grid=(1,), in_specs=[_spec((K, 2 * S), lambda b: (0, 0)),
                                 _spec((L, TB), lambda b: (0, 0)),
                                 _spec((1, TB), lambda b: (0, 0))],
        out_specs=_spec((L, TB), lambda b: (0, 0)), out_shape=_i32(L, TB))
    c = jnp.asarray(chars.numpy())
    chained = _load("probe_tpu30.py", "chained", f2=f2, L=L, TB=TB)
    return dict(tbl=tbl, chars=chars, entry=entry, w1=np.asarray(f1(tbl_j, c)),
                w2=np.asarray(f2(tbl_j, c, jnp.asarray(entry.numpy())[None])),
                w3_as_written=np.asarray(chained(tbl_j, c)))


def test_dfa_wide_equals_w1_and_w2(tpu30):
    tbl, chars, entry = tpu30["tbl"], tpu30["chars"], tpu30["entry"]
    got1 = p28.dfa_wide_plain(tbl, chars, **p30.FLAGS)
    got2 = p28.dfa_wide_plain(tbl, chars, entry=entry, **p30.FLAGS)
    assert np.array_equal(got1.numpy(), tpu30["w1"]) and np.array_equal(got2.numpy(), tpu30["w2"])
    assert not np.array_equal(tpu30["w1"], tpu30["w2"])  # the entry state is read


def test_two_chained_launches_equal_one(tpu30):
    """w3 as the segmented design means it: the second launch entered at
    the first's last row; the probe's ``chained`` (each half's rows
    doubled) is not the scan."""
    tbl, chars = tpu30["tbl"], tpu30["chars"]
    zero = torch.zeros(TB, dtype=torch.int32)
    assert np.array_equal(p30.chained(tbl, chars, zero).numpy(), tpu30["w1"])
    assert np.array_equal(p30.chained(tbl, chars, tpu30["entry"]).numpy(), tpu30["w2"])
    assert not np.array_equal(tpu30["w3_as_written"], tpu30["w1"])


# ------------------------------------------------------------ probe_tpu31


@pytest.fixture(scope="module")
def tpu31_calls():
    """build whole at each (K, S), L = 64, its call run from zeros."""
    build = _load("probe_tpu31.py", "build", TB=8, L=64, SLAB=SLAB,
                  rng=np.random.default_rng(31), np=np)
    out = {}
    for K, S in p31.SIZES:
        f, tbl, chars = build(K, S)
        out[(K, S)] = (tbl, chars, np.asarray(f(jnp.asarray(tbl), jnp.asarray(chars),
                                                jnp.zeros((1, 8), jnp.int32))))
    return out


@pytest.mark.parametrize("K,S", list(p31.SIZES))
def test_dfa_wide_equals_probe_tpu31(tpu31_calls, K, S):
    tbl, chars, want = tpu31_calls[(K, S)]
    got = p28.dfa_wide_plain(p28.as_table(tbl), _t(chars), **p31.FLAGS)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8


# ------------------------------------------------------------ probe_tpu32


@pytest.fixture(scope="module")
def tpu32_calls():
    """build whole for each case a-f in order (one generator), L = 64."""
    build = _load("probe_tpu32.py", "build", TB=8, L=64, SLAB=SLAB,
                  rng=np.random.default_rng(0), np=np)
    out = {}
    for name, (K, S, hi_lo, modulo, g2) in p32.CASES.items():
        f, tbl, chars, ts = build(K, S, hi_lo, modulo, g2)
        out[name] = (tbl, chars, ts, np.asarray(f(jnp.asarray(tbl), jnp.asarray(chars))))
    return out


@pytest.mark.parametrize("name", list(p32.CASES))
def test_dfa_wide_equals_probe_tpu32(tpu32_calls, name):
    tbl, chars, ts, want = tpu32_calls[name]
    _K, S, hi_lo, modulo, _g2 = p32.CASES[name]
    got = p28.dfa_wide_plain(p28.as_table(tbl), _t(chars), hilo=hi_lo, smod=modulo)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    ex = p32.exactness(got, torch.from_numpy(ts), _t(chars), modulo)
    if name.startswith("c"):  # bf16 rounds the table: a state of 1008, past the last
        assert not ex["exact"] and ex["max_state"] == S and ex["first_difference"] is not None
    elif S == 1008 and hi_lo:
        assert ex["exact"]


# ------------------------------------------------------------------ twins


def test_b_fragments_hold_the_table():
    """The product form's fragment order: lane 4 n8 + q holds rows k, k +
    1, k + 8, k + 9 (k = 16 kt + 2 q) of column 8 nt + n8, zeros past the
    table."""
    tbl = p28.as_table(np.random.default_rng(5).integers(0, 256, size=(40, 21)))
    f = p28.b_fragments(tbl)
    bits = tbl.view(torch.int16)
    assert tuple(f.shape) == (3, 3, 32, 4)
    for nt, kt, lane in ((0, 0, 0), (2, 1, 13), (1, 2, 31), (2, 2, 6)):
        k, n = 16 * kt + 2 * (lane & 3), 8 * nt + (lane >> 2)
        want = [int(bits[r, n]) if r < 40 and n < 21 else 0 for r in (k, k + 1, k + 8, k + 9)]
        assert f[nt, kt, lane].tolist() == want


def test_dfa_wide_refuses_and_mutation(tpu32_calls):
    """Bad tables and shapes are refused; the step without bf16's rounding
    (the integer table) is told apart from the probe's case c."""
    tbl, chars, ts, want = tpu32_calls["c_K96_S1008_single"]
    unrounded = p28.next_states(p28.as_table(tbl))
    unrounded[:96, :1008] = torch.from_numpy(ts)
    s = torch.zeros(8, dtype=torch.int64)
    rows = []
    for c in _t(chars).long():
        s = unrounded.reshape(-1)[c * 1009 + torch.where(s < 1008, s, 1008)]
        rows.append(s)
    assert not np.array_equal(torch.stack(rows).numpy(), want)
    with pytest.raises(ValueError, match="bf16"):
        p28.dfa_wide(p28.as_table(tbl).float(), _t(chars))
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        p28.dfa_wide(p28.as_table(tbl), _t(chars), hilo=True)
    with pytest.raises(ValueError, match="form"):
        p28.dfa_wide(p28.as_table(tbl), _t(chars), form="wgmma")
    with pytest.raises(ValueError, match="at most"):
        p28.dfa_wide(p28.as_table(np.zeros((257, 4))), _t(chars))
    with pytest.raises(ValueError, match="CUDA tensor"):
        p28.dfa_wide_cuda(p28.as_table(tbl), _t(chars))


@pytest.mark.parametrize("mod,n", [(p7, 10), (p28, 3), (p30, 5), (p31, 12),
                                   (p32, 12)])
def test_probe_scripts_on_cpu(mod, n, capsys):
    """``--device cpu`` runs the plain versions and reports host ms only;
    the default device is the card, with no fallback."""
    assert mod.main(["--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == n
    for r in recs:
        assert r["device"] == "cpu" and r["card"] == "cpu" and "host_ms" in r
        assert not {"ms", "ns_per_step", "launches", "table"} & set(r)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mod.main([])
