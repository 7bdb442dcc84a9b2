"""The table-kernel probes' plain versions against the probes themselves.

Each probe body is read from its script under ``tools/`` with ``ast``
(``_load`` of tests/test_torch_probes.py) and run by ``pallas_call`` in
interpret mode; the plain versions of ``halo2_regex_tpu_torch.probes``
must equal it bit for bit:

- probe_tpu.py's k3, k4 (``lane_gather_plain``), k5 (``row_gather_plain``),
  k6 and k7 (``dfa_step_plain``, batch-major);
- probe_tpu2.py's A (``nop_plain``, int32 that wraps), C and D
  (``dfa_step_plain`` time-major, one-hot and class-factored), E (1024
  gathers) and F (``onehot_count_plain``, bytes outside [0, 256)
  included);
- probe_tpu3.py's k1, ``make_scan_fullwidth``, ``make_scan_select`` and
  the gather loop k3;
- probe_tpu17.py's k (``int8_mma_plain``, the whole int8 range);
- probe_tpu18.py's ``build`` (``slab_anatomy_plain`` with 1, 2 and 4
  outputs; every output of its call is recorded, not only the first that
  ``run_one`` returns).

Each kernel family also has one mutation of its plain version that the
probe's output must tell apart.  The kernels themselves run only on the
card (tests/test_torch_cuda.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from halo2_regex_tpu_torch.probes import probe_tpu as p1
from halo2_regex_tpu_torch.probes import probe_tpu2 as p2
from halo2_regex_tpu_torch.probes import probe_tpu3 as p3
from halo2_regex_tpu_torch.probes import probe_tpu17 as p17
from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

from test_torch_probes import VMEM, _Interpret, _load, _t

TB, LB = 32, 48  # the small widths of the DFA-step probes


def _call(kern, out_shape, *args):
    """``kern`` through an interpret-mode ``pallas_call`` with every
    operand in VMEM, as the probes call it; numpy outputs."""
    outs = out_shape if isinstance(out_shape, list) else [out_shape]
    run = pl.pallas_call(kern, out_shape=out_shape, in_specs=[VMEM] * len(args),
                         out_specs=[VMEM] * len(outs) if isinstance(out_shape, list) else VMEM,
                         interpret=True)
    res = run(*(jnp.asarray(a) for a in args))
    return [np.asarray(r) for r in res] if isinstance(out_shape, list) else np.asarray(res)


def _i32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.int32)


def _T(seed=0):
    return p1.table(seed).numpy()


def _bytes(d0, d1, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, size=(d0, d1)).astype(np.int32)


def _dfa_from(T, c_tm, s0):
    """The lookup loop from state ``s0`` (a mutation of dfa_step's start)."""
    flat = T.reshape(-1).astype(np.int64)
    s = np.full(c_tm.shape[1], s0, np.int64)
    out = []
    for row in c_tm:
        s = flat[row * 128 + s]
        out.append(s)
    return np.stack(out).astype(np.int32)


class _LazyIota:
    """An iota built where it is compared.  make_scan_select builds its lane
    iota outside the kernel, which ``pallas_call`` refuses as a captured
    constant; built at its use inside the kernel, it is the same array."""

    def __init__(self, *args):
        self.args = args

    def __eq__(self, other):
        return jax.lax.broadcasted_iota(*self.args) == other

    __hash__ = None


class _Lax:
    def __getattr__(self, name):
        return getattr(jax.lax, name)

    broadcasted_iota = _LazyIota


class _JaxLazyIota:
    """``jax`` whose ``lax.broadcasted_iota`` is a ``_LazyIota``."""

    lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)


# ------------------------------------------------ the probes' outputs, once


@pytest.fixture(scope="module")
def gathers():
    """k3 and k4 (one gather), E and probe_tpu3's loop (1024), k1."""
    out = {}
    for name, R in (("k3", 8), ("k4", 256)):
        g, f = (a.numpy() for a in p1.gather_inputs(R, seed=R))
        out[name] = (g, f, 1, _call(_load("probe_tpu.py", name), _i32(R, 128), g, f))
    for script, name in (("probe_tpu2.py", "E"), ("probe_tpu3.py", "loop")):
        g, f = (a.numpy() for a in p1.gather_inputs(256, seed=len(name)))
        kern = _load(script, "k3")
        out[name] = (g, f, 1024, _call(kern, _i32(256, 128), g, f))
    g, f = (a.numpy() for a in p3.k1_inputs(64, seed=4))
    idx = np.random.default_rng(4).integers(0, 128, size=(64, 8)).astype(np.int32)
    idx[:, 0] = f[:, 0]  # k1 reads only the first column
    out["k1"] = (g, f, 1, _call(_load("probe_tpu3.py", "k1", TB=64), _i32(64, 128), g, idx))
    return out


@pytest.fixture(scope="module")
def scans():
    """The DFA-step probes: k6, k7 (batch-major), C, D, fullwidth, select
    (time-major): (T or Tk, bytes, form, time_major, pick, classes, out)."""
    T = _T(1)
    cb = _bytes(TB, LB, 2)
    ctm = _bytes(LB, TB, 3)
    out = {
        "k6": (T, cb, "onehot_mma", False, "gather", None,
               _call(_load("probe_tpu.py", "k6", TB=TB), _i32(TB, LB), T, cb)),
        "k7": (T, cb, "lookup", False, "gather", None,
               _call(_load("probe_tpu.py", "k7", TB=TB), _i32(TB, LB), T, cb)),
        "C": (T, ctm, "onehot_mma", True, "gather", None,
              _call(_load("probe_tpu2.py", "k"), _i32(LB, TB), T, ctm)),
    }
    classes, tk = (a.numpy() for a in p2.class_inputs(seed=5))
    cmat = np.zeros((256, 16), np.float32)
    cmat[np.arange(256), classes] = 1
    out["D"] = (tk, ctm, "class_mma", True, "gather", classes,
                _call(_load("probe_tpu2.py", "k2"), _i32(LB, TB), cmat, tk, ctm))
    for name, pick in (("make_scan_fullwidth", "gather"), ("make_scan_select", "sum")):
        kern = _load("probe_tpu3.py", name, S=128, jax=_JaxLazyIota())(TB, LB)
        out[name] = (T, ctm, "onehot_mma", True, pick, None, _call(kern, _i32(LB, TB), T, ctm))
    return out


@pytest.fixture(scope="module")
def slabs():
    """probe_tpu18's build at L = B = 64, TB = 32: every output of each
    call (n_out 1, 2, 4), bytes outside [0, 256) included."""
    seen = []

    class Recording(_Interpret):
        @staticmethod
        def pallas_call(*args, **kw):
            call = _Interpret.pallas_call(*args, **kw)

            def run(*a):
                outs = call(*a)
                seen.append([np.asarray(o) for o in outs])
                return outs

            return run

    build = _load("probe_tpu18.py", "build", L=64, B=64, TB=32, SLAB=8, np=np)
    build.__globals__["pl"] = Recording()
    out = {}
    for n in (1, 2, 4):
        build(n)(jnp.asarray(_headers()))
        out[n] = seen.pop()
    return _headers(), out


def _headers(L=64, B=64, seed=7):
    """Time-major bytes [L, B] that walk the from: DFA: header pieces and
    letters, with every eighth string's bytes drawn from [-300, 600)."""
    rng = np.random.default_rng(seed)
    pieces = [b"from:", b"@", b".", b"\r\n", b"bob", b"x.yz", b" ", b"<", b">"]
    x = np.zeros((L, B), np.int32)
    for b in range(B):
        if b % 8 == 7:
            x[:, b] = rng.integers(-300, 600, size=L)
            continue
        s = b"".join(pieces[j] for j in rng.integers(0, len(pieces), size=24))[:L]
        x[: len(s), b] = np.frombuffer(s, np.uint8)
    return x


# ----------------------------------------------------------------- lane_gather


@pytest.mark.parametrize("store", p1.STORES)
@pytest.mark.parametrize("name", ["k3", "k4", "E", "loop", "k1"])
def test_lane_gather_equals_probe(gathers, name, store):
    g, f, steps, want = gathers[name]
    got = p1.lane_gather_plain(_t(g), _t(f), steps, store)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p1.lane_gather(_t(g), _t(f), steps, store), got)  # the CPU entry point
    if steps > 1:
        assert len(np.unique(want)) > 1  # the chain does not collapse


@pytest.mark.parametrize("store", p1.STORES)
@pytest.mark.parametrize("name", ["k3", "k4", "E", "loop", "k1"])
def test_lane_gather_pow_equals_probe(gathers, name, store):
    """The pow form's twin (the row's map raised by squaring) gives the
    probes' outputs: 1024 steps are 10 squarings and one gather; one step
    (k1's g in [0, 999)) a gather alone."""
    g, f, steps, want = gathers[name]
    got = p1.lane_gather_pow_plain(_t(g), _t(f), steps, store)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(p1.lane_gather(_t(g), _t(f), steps, store, "pow").numpy(), want)
    assert len(p1.pow_rounds(steps)) == (11 if steps == 1024 else 1)


def test_row_gather_equals_k5():
    T = _T(3)
    c = np.random.default_rng(3).integers(0, 256, size=(8, 1)).astype(np.int32)
    want = _call(_load("probe_tpu.py", "k5"), _i32(8, 128), T, c)
    got = p1.row_gather(_t(T), _t(c[:, 0]))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# -------------------------------------------------------------------- dfa_step


@pytest.mark.parametrize("name", ["k6", "k7", "C", "D", "make_scan_fullwidth",
                                  "make_scan_select"])
def test_dfa_step_equals_probe(scans, name):
    T, c, form, tm, pick, classes, want = scans[name]
    cl = None if classes is None else _t(classes)
    got = p1.dfa_step_plain(_t(T), _t(c), form, tm, pick, cl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p1.dfa_step(_t(T), _t(c), form, tm, pick, cl), got)
    assert len(np.unique(want)) > 8  # the states move


def test_dfa_step_forms_agree():
    """The forms and picks are one function: T = Tk[classes] for class_mma."""
    classes, tk = p2.class_inputs(seed=9)
    c = torch.from_numpy(_bytes(LB, TB, 9))
    want = p1.dfa_step_plain(p1.dfa_table(tk, classes), c, time_major=True)
    for form, pick in (("lookup", "gather"), ("onehot_mma", "sum"), ("class_mma", "sum")):
        T = tk if form == "class_mma" else p1.dfa_table(tk, classes)
        got = p1.dfa_step(T, c, form, True, pick, classes if form == "class_mma" else None)
        assert torch.equal(got, want), (form, pick)
    assert torch.equal(p1.dfa_step(p1.dfa_table(tk, classes), c.t().contiguous()),
                       want.t().contiguous())


# ------------------------------------------------- nop, onehot_count, int8_mma


def test_nop_equals_knop():
    x = np.random.default_rng(1).integers(-2**31, 2**31, size=(8, 128),
                                          dtype=np.int64).astype(np.int32)
    x[0, :4] = [2**31 - 1, -1, 0, -2**31]  # the wrap
    want = _call(_load("probe_tpu2.py", "knop"), _i32(8, 128), x)
    got = p2.nop(_t(x))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want[0, 0] == -2**31


@pytest.mark.parametrize("lo,hi", [(0, 256), (-300, 600)])
def test_onehot_count_equals_f(lo, hi):
    c = _bytes(64, 32, hi, lo, hi)
    want = _call(_load("probe_tpu2.py", "k4"), _i32(1, 32), c)
    got = p2.onehot_count(_t(c))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if lo < 0:
        assert 0 < want.min() and want.max() < 64  # not trivially LB


@pytest.mark.parametrize("M,K,N,ranges", [(128, 128, 128, "probe"), (48, 96, 40, "int8")])
def test_int8_mma_equals_probe(M, K, N, ranges):
    a, b = (t.numpy() for t in p17.inputs(M, N, K, seed=M, probe=ranges == "probe"))
    if ranges == "int8":
        a[0, :4], b[:4, 0] = [-128, 127, -128, 127], [-128, -128, 127, 127]
    want = _call(_load("probe_tpu17.py", "k"), _i32(M, N), a, b)
    got = p17.int8_mma(_t(a), _t(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------- slab_anatomy


@pytest.mark.parametrize("n_out", [1, 2, 4])
def test_slab_anatomy_equals_build(slabs, n_out):
    x, outs = slabs
    model = p18.zoo.email_headers_model(max_chars_size=64, headers=("from",))
    tab, classes, first = p18.slab_tables(model)
    got = p18.slab_anatomy(tab, classes, _t(x), first, n_out)
    assert len(got) == len(outs[n_out]) == n_out
    for j, (g, w) in enumerate(zip(got, outs[n_out])):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w), j
    assert len(np.unique(outs[n_out][0])) > 4  # the DFA moves


# ------------------------------------------------------------------ mutations


def test_mutations_are_told_apart(gathers, scans, slabs):
    """One mutation of each family's plain version differs from the
    probe's output, so the equalities above hold the kernels' function."""
    g, f, steps, want = gathers["E"]
    assert not np.array_equal(p1.lane_gather_plain(_t(g), _t(f), steps - 1).numpy(), want)
    T, c, _form, _tm, _pick, _cl, want = scans["C"]
    assert not np.array_equal(_dfa_from(T, c, 1), want)  # dfa_step from state 1
    assert np.array_equal(_dfa_from(T, c, 0), want)
    x, outs = slabs
    model = p18.zoo.email_headers_model(max_chars_size=64, headers=("from",))
    tab, classes, first = p18.slab_tables(model)
    picks = p18.slab_anatomy_plain(tab, classes, _t(x), first, 2)
    assert not np.array_equal(picks[1].numpy(), outs[2][0])  # pick 1 stored as output 0
    x32 = torch.tensor([2**31 - 1], dtype=torch.int32)
    assert int(p2.nop_plain(x32)) != int(torch.clamp(x32.long() + 1, max=2**31 - 1))  # no wrap
    c = torch.from_numpy(_bytes(64, 32, 600, -300, 600))
    assert not torch.equal(p2.onehot_count_plain(c), (c < 256).sum(0, dtype=torch.int32)[None])
    a, b = p17.inputs(48, 40, 96, seed=2)
    unsigned = torch.matmul(a.to(torch.uint8).double(), b.double()).to(torch.int32)
    assert not torch.equal(p17.int8_mma_plain(a, b), unsigned)  # a read as uint8


# ------------------------------------------------------- wrappers and scripts


def test_ranges_and_shapes_are_refused():
    g, f = p1.gather_inputs(4)
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        p1.lane_gather(g + 128, f, 2)  # g's values are the next step's indices
    assert torch.equal(p1.lane_gather(g + 128, f, 1), torch.gather(g + 128, 1, f.long()))
    with pytest.raises(ValueError, match="f: expected"):
        p1.lane_gather(g, f[:, :64])
    T = p1.table()
    c = torch.from_numpy(_bytes(8, 16, 0))
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        p1.dfa_step(T, c + 256)
    with pytest.raises(ValueError, match="takes no classes"):
        p1.dfa_step(T, c, "lookup", classes=torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError, match="Tk"):
        p1.dfa_step(T, c, "class_mma", classes=torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError, match="form"):
        p1.dfa_step(T, c, "wgmma")
    with pytest.raises(ValueError, match="K"):
        p17.int8_mma(torch.zeros(2, p17.MAX_K + 1, dtype=torch.int8),
                     torch.zeros(p17.MAX_K + 1, 2, dtype=torch.int8))
    tab, classes, first = p18.slab_tables(
        p18.zoo.email_headers_model(max_chars_size=16, headers=("from",)))
    with pytest.raises(ValueError, match="n_out"):
        p18.slab_anatomy(tab, classes, p18.inputs(16, 8), first, 3)
    with pytest.raises(ValueError, match="first"):
        p18.slab_anatomy(tab, classes, p18.inputs(16, 8), tab.shape[1], 1)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A ``*_cuda`` wrapper raises on a CPU tensor (it never falls back)."""
    g, f = p1.gather_inputs(4)
    T, c = p1.table(), torch.from_numpy(_bytes(8, 16, 0))
    a, b = p17.inputs(64, 64, 64)
    tab, classes, first = p18.slab_tables(
        p18.zoo.email_headers_model(max_chars_size=16, headers=("from",)))
    for call in (lambda: p1.lane_gather_cuda(g, f), lambda: p1.row_gather_cuda(T, c[0]),
                 lambda: p1.dfa_step_cuda(T, c), lambda: p2.nop_cuda(c),
                 lambda: p2.onehot_count_cuda(c), lambda: p17.int8_mma_cuda(a, b),
                 lambda: p18.slab_anatomy_cuda(tab, classes, p18.inputs(16, 8), first, 1)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


@pytest.mark.parametrize("mod,n", [(p1, 11), (p2, 9), (p3, 5), (p17, 1), (p18, 3)])
def test_probe_scripts_on_cpu(mod, n, capsys):
    """``--device cpu`` runs the plain versions and reports host ms only;
    the default device is the card, with no fallback."""
    assert mod.main(["--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == n
    for r in recs:
        assert r["device"] == "cpu" and r["card"] == "cpu" and "host_ms" in r
        assert not {"ms", "ns_per_step", "cycles_per_step", "launches", "tflops"} & set(r)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mod.main([])
