"""The launch, accumulate, carry and class-chain probes' plain versions
against the probes themselves.

Each probe body is read from its script under ``tools/`` with ``ast``
(``_load`` of tests/test_torch_probes.py, by line where a name repeats,
the ``lambda`` of probe_tpu67 from its call) and run by ``pallas_call`` in
interpret mode with the grid and block specs its script gives it; the
plain versions of ``halo2_regex_tpu_torch.probes`` must equal it bit for
bit:

- probe_tpu21's D (``mm_kern``): ``mma_accum_plain``, exact on the probe's
  all-ones and on integers in [-8, 8], within 2e-5 x sum |a b| on N(0, 1);
- probe_tpu20's D raises as written (its dot gives [1, 128, 1, 128]);
- probe_tpu20's E (``kern2``) raises as written too (the store of a [1,
  NWS, 128] value into ``st_scr[0]``); with the size-1 class axis squeezed
  from its block specs the body runs unchanged, one position a chunk:
  zeros from its zeroed scratch, ``bitop_carry_plain`` from a hashed
  start;
- probe_tpu6's k1 (``loop_floor_plain``) and k4 (``class_chain_plain`` in
  both forms, bytes outside [0, 256) included);
- probe_tpu67's A (the copy ``lambda``): ``tile_move`` copy, into a given
  buffer too, and the chains of it.

Each kernel family has one mutation of its plain version that the
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
from jax.experimental.pallas import tpu as pltpu

from halo2_regex_tpu_torch.probes import probe_tpu6 as p6
from halo2_regex_tpu_torch.probes import probe_tpu20 as p20
from halo2_regex_tpu_torch.probes import probe_tpu21 as p21
from halo2_regex_tpu_torch.probes import probe_tpu47 as p47
from halo2_regex_tpu_torch.probes import probe_tpu67 as p67

from test_torch_probes import (VMEM, _HashStart, _hash_like, _i32, _Interpret, _load,
                               _spec, _t)


# ------------------------------------------------------------------- D: mma


def _mm_call(kern):
    """The probes' D call (tools/probe_tpu21.py:112-125): grid (4, 2), a
    [1, 1, 128, 128] block of a, b and the output, f32 scratch [128, 128]."""
    block = _spec((1, 1, 128, 128), lambda i, l: (i, l, 0, 0))
    return _Interpret.pallas_call(kern, grid=(4, 2), in_specs=[block, block], out_specs=block,
                                  out_shape=jax.ShapeDtypeStruct((4, 2, 128, 128), jnp.float32),
                                  scratch_shapes=[pltpu.VMEM((128, 128), jnp.float32)])


@pytest.fixture(scope="module")
def mm_outs():
    """probe_tpu21's D on each kind of input: (a, b, output)."""
    call = _mm_call(_load("probe_tpu21.py", "mm_kern"))
    out = {}
    for kind in p21.KINDS:
        a, b = p21.inputs(p21.SHAPE, kind, seed=3)
        fa, fb = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (a, b))
        out[kind] = (a, b, np.asarray(call(fa, fb)))
    return out


@pytest.mark.parametrize("kind", ["ones", "ints"])
def test_mma_accum_equals_probe_tpu21_d(mm_outs, kind):
    a, b, want = mm_outs[kind]
    got = p21.mma_accum(a, b)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    if kind == "ones":  # 128 a sum, carried over l: 128 at l = 0, 256 at l = 1
        assert set(np.unique(want[:, 0])) == {128.0} and set(np.unique(want[:, 1])) == {256.0}


def test_mma_accum_within_tolerance_on_normal_inputs(mm_outs):
    a, b, want = mm_outs["normal"]
    got = p21.mma_accum_plain(a, b)
    assert bool((got - _t(want)).abs().le(p21.tolerance(a, b)).all())
    assert bool(p21.tolerance(a, b).gt(0).all())


def test_probe_tpu20_d_raises_as_written():
    """probe_tpu20's D: ``a_ref[0]`` is [1, 128, 128], so its dot is [1,
    128, 1, 128] and the store refuses it; the port runs the corrected
    body (probe_tpu21's) in its D line."""
    a = jnp.ones((4, 2, 128, 128), jnp.bfloat16)
    with pytest.raises(ValueError, match="Invalid shape"):
        _mm_call(_load("probe_tpu20.py", "mm_kern"))(a, a)
    d = [r for r in p20.run_de(torch.device("cpu"), 256, 1, 64) if r["probe"][0] == "D"]
    assert [r["kernel"] for r in d] == ["mma_accum"] and d[0]["shape"] == list(p21.SHAPE)


# ---------------------------------------------------------------- E: carry


def _e_call(kern, L, nws, lc, squeeze):
    """probe_tpu20's E call (tools/probe_tpu20.py:267-279): grid (2, L /
    lc), cls blocks [1, lc, 1, NWS, 128], out blocks [1, 1, 1, NWS, 128],
    scratch [1, NWS, 128]; ``squeeze``: the size-1 class axis dropped from
    both blocks (``None``)."""
    one = None if squeeze else 1
    return _Interpret.pallas_call(
        kern, grid=(2, L // lc),
        in_specs=[_spec((1, lc, one, nws, 128), lambda b, l: (b, l, 0, 0, 0))],
        out_specs=_spec((1, 1, one, nws, 128), lambda b, l: (b, 0, 0, 0, 0)),
        out_shape=_i32(2, 1, 1, nws, 128), scratch_shapes=[pltpu.VMEM((1, nws, 128), jnp.int32)])


L_E, NWS_E, LC_E = 256, 2, 64


@pytest.fixture(scope="module")
def e_outs():
    cls, _st0 = p20.carry_inputs(L_E, NWS_E, seed=5)
    out = {"cls": cls}
    for start in ("zero", "hash"):
        free = {"jnp": _HashStart()} if start == "hash" else {}
        kern = _load("probe_tpu20.py", "kern2", **free)
        out[start] = np.asarray(_e_call(kern, L_E, NWS_E, LC_E, True)(jnp.asarray(cls.numpy())))
    return out


def test_probe_tpu20_e_raises_as_written():
    cls, _st0 = p20.carry_inputs(L_E, NWS_E, seed=5)
    with pytest.raises(ValueError, match="Invalid shape"):
        _e_call(_load("probe_tpu20.py", "kern2"), L_E, NWS_E, LC_E, False)(
            jnp.asarray(cls.numpy()))


@pytest.mark.parametrize("start", ["zero", "hash"])
def test_bitop_carry_equals_e(e_outs, start):
    """One position a chunk: zeros from the probe's zeroed scratch, the
    carry recurrence from a hashed one."""
    cls, want = e_outs["cls"], e_outs[start]
    if start == "hash":
        st0 = np.asarray(jax.jit(_hash_like)(jnp.zeros((1, NWS_E, 128), jnp.int32)))
    else:
        st0 = np.zeros((1, NWS_E, 128), np.int32)
    got = p20.bitop_carry_plain(cls, _t(st0), LC_E, 1)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p20.bitop_carry(cls, _t(st0), LC_E, 1), got)  # the CPU entry point
    assert bool(want.any()) == (start == "hash")


def test_bitop_carry_every_position_is_the_recurrence():
    """steps = lc: st ^= c & st at every position in order (the carry scan
    E meant), equal to st & ~(c_0 | c_1 | ...)."""
    cls, st0 = p20.carry_inputs(128, 1, seed=2)
    got = p20.bitop_carry_plain(cls, st0, 32, 32)
    ors = torch.zeros_like(cls[:, 0, 0])
    for i in range(128):
        ors |= cls[:, i, 0]
    assert torch.equal(got[:, 0, 0], st0[0] & ~ors)


# ------------------------------------------------------------------ k1, k4


def test_loop_floor_equals_k1():
    TB, LC, NL = 32, 32, 2
    x = np.random.default_rng(1).integers(0, 5, size=(LC * NL, 2 * TB)).astype(np.int32)
    kern = _load("probe_tpu6.py", "k1", TB=TB, LC=LC)
    block = _spec((LC, TB), lambda b, l: (l, b))
    want = np.asarray(_Interpret.pallas_call(
        kern, grid=(2, NL), in_specs=[block], out_specs=block, out_shape=_i32(LC * NL, 2 * TB),
        scratch_shapes=[pltpu.VMEM((1, TB), jnp.int32)])(jnp.asarray(x)))
    got = p6.loop_floor_plain(_t(x), 1)
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, np.cumsum(x, 0))


@pytest.fixture(scope="module")
def k4_outs():
    """k4 on the probe's terms, bytes and ints far outside [0, 256)."""
    terms = p6.inputs()["terms"]
    out = {}
    for lo, hi in ((0, 256), (-1000, 1300)):
        x = np.random.default_rng(hi).integers(lo, hi, size=(32, 48)).astype(np.int32)
        kern = _load("probe_tpu6.py", "k4", terms=terms, TB=48, LC=32)
        run = pl.pallas_call(kern, out_shape=_i32(32, 48), in_specs=[VMEM], out_specs=VMEM,
                             interpret=True)
        out[(lo, hi)] = (x, np.asarray(run(jnp.asarray(x))))
    return terms, out


@pytest.mark.parametrize("form", p6.CHAIN_FORMS)
@pytest.mark.parametrize("lo,hi", [(0, 256), (-1000, 1300)])
def test_class_chain_equals_k4(k4_outs, lo, hi, form):
    terms, outs = k4_outs
    x, want = outs[(lo, hi)]
    got = p6.class_chain_plain(_t(x), terms, form)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p6.class_chain(_t(x), terms, form), got)  # the CPU entry point
    assert torch.equal(p6.chain_library(_t(x), terms)(), got)
    assert len(np.unique(want)) > 4


def test_class_chain_refuses_what_the_table_cannot_hold():
    c = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[1, 255\]"):
        p6.class_chain(c, [(256, 1)], "table")
    with pytest.raises(ValueError, match="at most 32"):
        p6.class_chain(c, [(1, 1)] * 33)
    with pytest.raises(ValueError, match="form"):
        p6.class_chain(c, [(1, 1)], "wgmma")
    # the chain form takes any threshold: below every byte, and above
    assert torch.equal(p6.class_chain(c + 5, [(0, 2), (300, 7)]), torch.full_like(c, 2))


# ------------------------------------------------------------- probe_tpu67 A


def test_tile_move_copy_equals_the_lambda():
    """A's body is the ``lambda`` at tools/probe_tpu67.py:127, a copy of
    [1, 1024, 128] blocks over grid (nblk,)."""
    copy = _load("probe_tpu67.py", "lambda", line=127)
    x = p47.words((2, 1024, 128), seed=3, lo=0, hi=2**31)
    block = _spec((1, 1024, 128), lambda b: (b, 0, 0))
    want = np.asarray(_Interpret.pallas_call(copy, grid=(2,), in_specs=[block], out_specs=block,
                                             out_shape=_i32(2, 1024, 128))(jnp.asarray(x.numpy())))
    assert np.array_equal(p47.tile_move_plain(x, "copy").numpy(), want)
    y = torch.empty_like(x)
    assert p47.tile_move(x, "copy", out=y) is y and np.array_equal(y.numpy(), want)
    for chain in (p67.copy_chain(x, torch.empty_like(x)), p67.clone_chain(x)):
        assert torch.equal(chain(3), x)


def test_loader_picks_by_line_and_reads_lambdas():
    """probe_tpu32's ``build`` holds two ``kern``s (:59 and :99): a name
    that repeats needs its line; a lambda is read from its call."""
    with pytest.raises(AssertionError):
        _load("probe_tpu32.py", "kern")
    k59, k99 = (_load("probe_tpu32.py", "kern", line=n) for n in (59, 99))
    assert k59.__code__.co_argcount == 4 and k99.__code__.co_argcount == 3
    assert _load("probe_tpu67.py", "lambda", line=127).__code__.co_argcount == 2
    with pytest.raises(AssertionError):
        _load("probe_tpu67.py", "lambda", line=126)


# ------------------------------------------------------------------ mutations


def test_mutations_are_told_apart(mm_outs, e_outs, k4_outs):
    """One mutation of each family's plain version differs from the probe's
    output, so the equalities above hold the kernels' function."""
    a, b, want = mm_outs["ints"]
    no_carry = torch.stack([torch.matmul(a[:, l].float(), b[:, l].float()) for l in range(2)], 1)
    assert not np.array_equal(no_carry.numpy(), want)  # the accumulator not carried over l
    cls = e_outs["cls"]
    st0 = _t(np.asarray(jax.jit(_hash_like)(jnp.zeros((1, NWS_E, 128), jnp.int32))))
    assert not np.array_equal(p20.bitop_carry_plain(cls, st0, LC_E, 2).numpy(), e_outs["hash"])
    terms, outs = k4_outs
    x, want4 = outs[(-1000, 1300)]
    strict = torch.zeros(x.shape, dtype=torch.int32)
    for bb, d in terms:
        strict += d * (_t(x) > bb).to(torch.int32)
    assert not np.array_equal(strict.numpy(), want4)  # > for >=
    unclamped = p6._chain(torch.arange(256, dtype=torch.int32), terms)[_t(x).remainder(256).long()]
    assert not np.array_equal(unclamped.numpy(), want4)  # the table read without the clamp


# ------------------------------------------------------- wrappers and scripts


def test_kernel_wrappers_refuse_cpu_tensors():
    a, b = p21.inputs((1, 1, 64, 64), "ints")
    cls, st0 = p20.carry_inputs(128, 1)
    c = torch.zeros((4, 4), dtype=torch.int32)
    for call in (lambda: p21.mma_accum_cuda(a, b), lambda: p20.bitop_carry_cuda(cls, st0),
                 lambda: p6.class_chain_cuda(c, [(1, 1)])):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


@pytest.mark.parametrize("mod,argv,n", [(p21, [], 3), (p20, ["--sections", "DE"], 4),
                                        (p6, [], 6), (p67, [], 4)])
def test_probe_scripts_on_cpu(mod, argv, n, capsys):
    """``--device cpu`` runs the plain versions and reports host ms only;
    the default device is the card, with no fallback."""
    assert mod.main(["--device", "cpu", *argv]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == n
    for r in recs:
        assert r["device"] == "cpu" and r["card"] == "cpu" and "host_ms" in r
        assert not {"ms", "ns_per_step", "launches", "tflops", "input_gbps"} & set(r)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mod.main([])


def test_harness_wall_slope_and_tolerance():
    """``wall_slope`` on the CPU: host walls at both chain lengths and the
    slope a call; ``measure``'s tolerance is elementwise and ``status``
    passes a line within it."""
    from halo2_regex_tpu_torch.probes import harness

    sl = harness.wall_slope(torch.device("cpu"), lambda k: [torch.ones(4) for _ in range(k)],
                            (1, 3), 2)
    assert set(sl["wall_ms"]) == {"1", "3"} and "device_slope_ms" not in sl
    got, want = torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.5])
    assert harness.max_abs_err(got, want) == 0.5
    assert harness.within(got, want, torch.tensor([0.0, 0.5]))
    assert not harness.within(got, want, torch.tensor([0.5, 0.4]))
    assert harness.status([{"max_abs_err": 0.5, "within_tolerance": True}]) == 0
    assert harness.status([{"max_abs_err": 0.5, "within_tolerance": False}]) == 1
