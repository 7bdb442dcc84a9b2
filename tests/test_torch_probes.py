"""The serial-scan probes' plain versions against the probes themselves.

Each probe body is read from its script under ``tools/`` with ``ast`` (the
scripts run their probes when imported, or nest the bodies in ``main()``)
and executed in a namespace that supplies its free names, with a ``pl``
whose ``pallas_call`` runs in interpret mode (as tools/probe_smoke.py does,
without patching ``pl`` for anyone else).  The plain versions of
``halo2_regex_tpu_torch.probes`` must equal them bit for bit:

- probe_tpu9's A (``ka``) and B (``kb``): ``loop_floor_plain``, int32 sums
  that wrap included;
- probe_tpu9's C (``kc``): ``slab_scan_plain``, bytes outside [0, 256)
  included (the probe's class thresholds clamp them);
- probe_tpu20's A (``make_scan_probe``): ``bitop_scan_plain`` over two or
  more chunks, from the probe's zero start and from a nonzero one (a
  ``jnp`` whose ``zeros_like`` hashes an in-kernel iota: a captured array
  is refused by ``pallas_call``);
- probe_tpu56's A (``make_chains_kernel``): ``chains_plain``.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from halo2_regex_tpu_torch.probes import probe_tpu9 as p9
from halo2_regex_tpu_torch.probes import probe_tpu20 as p20
from halo2_regex_tpu_torch.probes import probe_tpu56 as p56

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _spec(shape, index):
    """A VMEM block spec of ``shape`` at ``index``, as the probes write them."""
    return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)


def _i32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.int32)


class _Interpret:
    """``pl`` with ``pallas_call`` in interpret mode, for one namespace."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return pl.pallas_call(*args, **kw)


def _hash_like(x):
    """An int32 hash of the element indices of ``x``'s shape, built from
    iotas (so it can run inside a kernel)."""
    shape = x.shape
    v = jnp.zeros(shape, jnp.int32)
    for d in range(len(shape)):
        v = v * 1000003 + jax.lax.broadcasted_iota(jnp.int32, shape, d) + 7
    v = v * -1640531535
    return v ^ (v >> 15)


class _HashStart:
    """``jnp`` whose ``zeros_like`` returns ``_hash_like``: a nonzero start
    for probe_tpu20's scratch."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def zeros_like(x):
        return _hash_like(x)


def _load(script: str, name: str, line=None, **free):
    """The function ``name`` of ``tools/<script>`` (at any depth; where the
    name repeats, the one defined at ``line``), defined in a namespace of
    jax, jnp, an interpret-mode pl, pltpu and ``free``.  With ``name``
    ``"lambda"``, the lambda written at ``line`` (a body passed straight to
    its ``pallas_call``).  A function that makes its call (probe_tpu32's
    ``build``, probe_tpu7's ``scan_kernel``, probe_tpu28's ``try_variant``)
    loads whole: its inner kernels and its ``pallas_call`` run in the same
    namespace."""
    path = os.path.join(TOOLS, script)
    with open(path) as f:
        tree = ast.parse(f.read())
    ns = {"jax": jax, "jnp": jnp, "pl": _Interpret(), "pltpu": pltpu, **free}
    if name == "lambda":
        nodes = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda) and n.lineno == line]
        assert len(nodes) == 1, (script, line, len(nodes))
        return eval(compile(ast.Expression(body=nodes[0]), path, "eval"), ns)
    nodes = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name
             and (line is None or n.lineno == line)]
    assert len(nodes) == 1, (script, name, line, len(nodes))
    exec(compile(ast.Module(body=nodes, type_ignores=[]), path, "exec"), ns)
    return ns[name]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


# ---------------------------------------------------------------- probe_tpu9


@pytest.mark.parametrize("values", ["bytes", "wrap"])
@pytest.mark.parametrize("L,TB", [(64, 16), (128, 32)])
@pytest.mark.parametrize("probe,slab", [("ka", 1), ("kb", 8)])
def test_loop_floor_equals_probe(probe, slab, L, TB, values):
    rng = np.random.default_rng(L + TB + slab)
    lo, hi = (0, 256) if values == "bytes" else (2**30, 2**31)  # "wrap": the sums overflow
    x = rng.integers(lo, hi, size=(L, TB), dtype=np.int64).astype(np.int32)
    kern = _load("probe_tpu9.py", probe, L=L, TB=TB, SB=8)
    run = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((L, TB), jnp.int32),
                         in_specs=[VMEM], out_specs=VMEM, interpret=True)
    want = np.asarray(run(jnp.asarray(x)))
    got = p9.loop_floor_plain(_t(x), slab)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p9.loop_floor(_t(x), slab), got)  # the entry point on the CPU
    if values == "bytes":
        assert np.array_equal(want, np.cumsum(x, 0))


def _terms(classes: np.ndarray):
    """probe_tpu9 C's class thresholds (tools/probe_tpu9.py:113-118)."""
    terms = [(c, int(classes[c]) - int(classes[c - 1])) for c in range(1, 256)
             if int(classes[c]) - int(classes[c - 1])]
    return terms, int(classes[0])


@pytest.mark.parametrize("bytes_", ["in_range", "any_int"])
@pytest.mark.parametrize("L,TB", [(64, 16), (128, 32)])
def test_slab_scan_equals_probe(L, TB, bytes_):
    K, S = p9.K, p9.S
    rng = np.random.default_rng(L * TB)
    classes = rng.integers(0, K, size=256).astype(np.int32)
    tk = rng.integers(0, S, size=(K, 4 * S)).astype(np.int32)
    lo, hi = (0, 256) if bytes_ == "in_range" else (-300, 600)
    x = rng.integers(lo, hi, size=(L, TB)).astype(np.int32)
    terms, cls0 = _terms(classes)
    kern = _load("probe_tpu9.py", "kc", L=L, TB=TB, SB=8, S=S, K=K, terms=terms, cls0=cls0)
    run = pl.pallas_call(kern, out_shape=[jax.ShapeDtypeStruct((L, TB), jnp.int32)] * 4,
                         in_specs=[VMEM, VMEM], out_specs=[VMEM] * 4, interpret=True)
    want = [np.asarray(o) for o in run(jnp.asarray(tk.astype(np.float32)), jnp.asarray(x))]
    got = p9.slab_scan_plain(_t(tk), _t(classes), _t(x))
    assert len(got) == 4
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w), j
    assert len({int(v) for v in want[0].ravel()}) > 1  # the chain moves


def test_slab_scan_refuses_tables_beyond_the_probe():
    x, classes, tk = p9.inputs(16, 8, seed=3)
    bad_tk = tk.clone()
    bad_tk[0, 0] = p9.S  # a state past the table: the probe's select gives 0 there
    with pytest.raises(ValueError, match=r"\[0, S"):
        p9.slab_scan(bad_tk, classes, x)
    bad_cls = classes.clone()
    bad_cls[7] = p9.K
    with pytest.raises(ValueError, match=r"\[0, K"):
        p9.slab_scan(tk, bad_cls, x)
    with pytest.raises(ValueError, match="multiple of"):
        p9.slab_scan(tk, classes, x[:12])
    with pytest.raises(ValueError, match="slab"):
        p9.loop_floor(x[:12], 8)


# --------------------------------------------------------------- probe_tpu20


@pytest.mark.parametrize("n_ops,k,sb,lc", [(96, 12, 5, 128), (192, 12, 5, 128),
                                           (96, 8, 3, 64)])
@pytest.mark.parametrize("start", ["hash", "zero"])
def test_bitop_scan_equals_probe(n_ops, k, sb, lc, start):
    L, NWS, LANE = 256, 1, 128  # at least two chunks, so the restart of acc shows
    rng = np.random.default_rng(n_ops + k)
    cls = rng.integers(0, 2**31, size=(L, k, NWS, LANE)).astype(np.int32)
    free = dict(L=L, NWS=NWS, LANE=LANE)
    if start == "hash":
        free["jnp"] = _HashStart()
        st0 = np.asarray(jax.jit(_hash_like)(jnp.zeros((sb, NWS, LANE), jnp.int32)))
    else:
        st0 = np.zeros((sb, NWS, LANE), np.int32)
    make = _load("probe_tpu20.py", "make_scan_probe", **free)
    want = np.asarray(jax.jit(make(n_ops, k=k, sb=sb, lc=lc))(jnp.asarray(cls)))
    got = p20.bitop_scan_plain(_t(cls), _t(st0), n_ops, sb=sb, k=k, lc=lc)
    assert got.dtype == torch.int32 and got.shape == (L, 1, NWS, LANE)
    assert np.array_equal(got.numpy(), want)
    # the probe's zero start stays zero: the trap the kernel's st0 input avoids
    assert bool(want.any()) == (start == "hash")


def test_bitop_scan_entry_point_on_cpu():
    cls, st0 = p20.inputs(32, 1, seed=5)
    got = p20.bitop_scan(cls, st0, 96, lc=16)
    assert torch.equal(got, p20.bitop_scan_plain(cls, st0, 96, lc=16))
    with pytest.raises(ValueError, match="st0"):
        p20.bitop_scan(cls, st0[:3], 96)


# --------------------------------------------------------------- probe_tpu56


@pytest.mark.parametrize("n_steps", [8, 4096])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_chains_equals_probe(C, n_steps):
    x = p56.inputs(C, seed=C)
    make = _load("probe_tpu56.py", "make_chains_kernel", N_STEPS=n_steps)
    want = np.asarray(jax.jit(make(C))(jnp.asarray(x.numpy())))
    got = p56.chains_plain(x, n_steps)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p56.chains(x, n_steps), got)


def test_chains_probe_input_keeps_words():
    """At the probe's own C=1 input (seed 0), 123 of 1024 words are still
    nonzero after 4096 steps: the card check compares whole outputs."""
    assert int((p56.chains_plain(p56.inputs(1, seed=0), 4096) != 0).sum()) == 123


# ------------------------------------------------------- wrappers and scripts


def test_kernel_wrappers_refuse_cpu_tensors():
    """A ``*_cuda`` wrapper raises on a CPU tensor (it never falls back)."""
    x, classes, tk = p9.inputs(16, 8)
    cls, st0 = p20.inputs(8, 1)
    for call in (lambda: p9.loop_floor_cuda(x, 1), lambda: p9.slab_scan_cuda(tk, classes, x),
                 lambda: p20.bitop_scan_cuda(cls, st0, 96),
                 lambda: p56.chains_cuda(p56.inputs(2), 8)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="built for n_ops"):
        p20.bitop_scan_cuda(cls, st0, 100)


@pytest.mark.parametrize("mod,n", [(p9, 3), (p20, 1), (p56, 6)])
def test_probe_scripts_on_cpu(mod, n, capsys):
    """``--device cpu`` runs the plain versions and reports host ms only;
    the default device is the card, with no fallback."""
    assert mod.main(["--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == n
    for r in recs:
        assert r["device"] == "cpu" and r["card"] == "cpu" and "host_ms" in r
        assert not {"ms", "ns_per_step", "cycles_per_step", "launches"} & set(r)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mod.main([])


def test_harness_compares_outputs_exactly():
    """``max_abs_err`` (the card check of every measurement) sees a
    difference of one in any output of a tuple, and refuses a dtype or
    shape that differs; ``status`` fails a script with such a line."""
    from halo2_regex_tpu_torch.probes import harness

    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = a.clone()
    b[2, 1] += 1
    assert harness.max_abs_err((a, a), (a, a)) == 0
    assert harness.max_abs_err((a, a), (a, b)) == 1
    for other in (a.long(), a[:2]):
        with pytest.raises(AssertionError, match="shape/dtype"):
            harness.max_abs_err(a, other)
    assert harness.status([{"max_abs_err": 0}, {"host_ms": 1.0}]) == 0
    assert harness.status([{"max_abs_err": 0}, {"max_abs_err": 3}]) == 1
