"""The emission and decode probes' plain versions against the probes themselves.

Each probe body is read from its script under ``tools/`` with ``ast``
(``_load`` of tests/test_torch_probes.py; probe_tpu47 and probe_tpu48 run
their work when imported, so only their kernel bodies are loaded, with
their module-level names as free names) and run by ``pallas_call`` in
interpret mode, as the probes call it; the plain versions of
``halo2_regex_tpu_torch.probes`` must equal it bit for bit:

- probe_tpu47's kern_t and kern_c, probe_tpu48's kern_id and probe_tpu64's
  kern_copy and kern_swap (through its ``mkk``): ``tile_move_plain``;
- probe_tpu48's kern_direct and probe_tpu64's kern_mxu (with its
  ``packing_matrix``): ``l4_pack_plain`` in every form;
- probe_tpu64's make_mxdecode and probe_tpu68's make_decode ("mx" with
  its ``selector_matrix``, "sw"), on random int32 words and on the g4 of
  the port's witness front (``post_plain``) on the from: model:
  ``field_decode_plain`` in every form, which also equals B14's
  ``decode_plain``.

probe_tpu68's pipeline (``witness_pipeline``) equals the port's witness
matcher on the CPU in every form, and once the JAX ``BitplaneMatcher``'s
witness.  Each kernel family has one mutation of its plain version that
the probe's output must tell apart.  The kernels themselves run only on
the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.probes import probe_tpu47 as p47
from halo2_regex_tpu_torch.probes import probe_tpu48 as p48
from halo2_regex_tpu_torch.probes import probe_tpu64 as p64
from halo2_regex_tpu_torch.probes import probe_tpu68 as p68

from test_torch_probes import _load, _t

LANE = 128
B, L = 4096, 128  # the decodes' batch: NWS = 1
VMEM = dict(memory_space=pltpu.VMEM)


def _i32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.int32)


# ----------------------------------------------------------------- tile_move


def _tile_t_probe(x: np.ndarray, name: str) -> np.ndarray:
    """probe_tpu47's kern_t or kern_c over x [NWS, M, L, LANE], the
    probe's (LC, LANE) tiles and grid."""
    NWS, M, Lx, _ = x.shape
    LC = 256
    kern = _load("probe_tpu47.py", name)
    spec_in = pl.BlockSpec((1, 1, LC, LANE), lambda a, b, c: (a, b, c, 0), **VMEM)
    if name == "kern_t":
        spec_out = pl.BlockSpec((1, 1, LANE, LC), lambda a, b, c: (a, b, 0, c), **VMEM)
        shape = (NWS, M, LANE, Lx)
    else:
        spec_out, shape = spec_in, x.shape
    call = pl.pallas_call(kern, grid=(NWS, M, Lx // LC), in_specs=[spec_in], out_specs=spec_out,
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.int32), interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def _tiles_in_place(x: torch.Tensor, T: int = 64) -> torch.Tensor:
    """A mutation of the transpose: each T x T tile transposed where it
    stands, not moved to its mirror position."""
    y = x.clone()
    R, C = x.shape[-2:]
    for i in range(0, R, T):
        for j in range(0, C, T):
            y[..., i:i + T, j:j + T] = x[..., i:i + T, j:j + T].transpose(-2, -1)
    return y


@pytest.mark.parametrize("name,form", [("kern_t", "transpose"), ("kern_c", "copy")])
def test_tile_move_equals_probe47(name, form):
    x = p47.words((2, 2, 512, LANE), seed=1)
    want = _tile_t_probe(x.numpy(), name)
    got = p47.tile_move_plain(x, form)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p47.tile_move(x, form), got)  # the entry point on the CPU
    if form == "transpose":  # the mutation the probe tells apart
        assert not np.array_equal(_tiles_in_place(x[..., :128, :]).numpy(), want[..., :128])


def test_tile_move_copy_equals_kern_id():
    x = p47.words((2, 3, 64, LANE), seed=2)
    NWS, M, Lx, _ = x.shape
    kern = _load("probe_tpu48.py", "kern_id", M=M)
    spec = pl.BlockSpec((1, M, Lx, LANE), lambda b: (b, 0, 0, 0), **VMEM)
    call = pl.pallas_call(kern, grid=(NWS,), in_specs=[spec], out_specs=spec,
                          out_shape=_i32(*x.shape), interpret=True)
    assert np.array_equal(p47.tile_move_plain(x, "copy").numpy(),
                          np.asarray(call(jnp.asarray(x.numpy()))))


@pytest.fixture(scope="module")
def mkk64():
    """probe_tpu64's mkk, kern_copy, kern_swap, kern_mxu and its packing
    matrix, over X [2, 1024, 128] in [0, 2^31)."""
    x = p47.words((2, 1024, LANE), seed=3, lo=0, hi=2**31)
    mkk = _load("probe_tpu64.py", "mkk", X=jnp.asarray(x.numpy()), LANE=LANE, NBLK=2)
    kerns = {n: _load("probe_tpu64.py", n, LANE=LANE)
             for n in ("kern_copy", "kern_swap", "kern_mxu")}
    pmat = _load("probe_tpu64.py", "packing_matrix", np=np)()
    return x, mkk, kerns, pmat


@pytest.mark.parametrize("name,form", [("kern_copy", "copy"), ("kern_swap", "transpose")])
def test_tile_move_equals_probe64(mkk64, name, form):
    x, mkk, kerns, _ = mkk64
    shape = x.shape if form == "copy" else (2, LANE, 1024)
    f, args = mkk(kerns[name], shape)
    assert np.array_equal(p47.tile_move_plain(x, form).numpy(), np.asarray(f(*args)))


# ------------------------------------------------------------------- l4_pack


def _swap_s(rows: torch.Tensor) -> torch.Tensor:
    """A mutation: byte lanes s and s ^ 1 of every row block swapped."""
    *lead, R, c = rows.shape
    return rows.reshape(*lead, R // 4, 4, c)[..., [1, 0, 3, 2], :].reshape(rows.shape)


@pytest.mark.parametrize("form", p48.FORMS)
def test_l4_pack_equals_kern_direct(form):
    w = p47.words((2, 3, 256, LANE), seed=4)
    NWS, M, Lx, _ = w.shape
    kern = _load("probe_tpu48.py", "kern_direct", M=M, L4=Lx // 4, LANE=LANE)
    call = pl.pallas_call(
        kern, grid=(NWS,),
        in_specs=[pl.BlockSpec((1, M, Lx, LANE), lambda b: (b, 0, 0, 0), **VMEM)],
        out_specs=pl.BlockSpec((M, 1, LANE * 4, Lx // 4), lambda b: (0, b, 0, 0), **VMEM),
        out_shape=_i32(M, NWS, LANE * 4, Lx // 4), interpret=True)
    want = np.asarray(call(jnp.asarray(w.numpy())))
    got = p48.l4_pack_plain(w, form)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(p48.l4_pack(w, form), got)
    assert not np.array_equal(_swap_s(got).numpy(), want)
    # the direct [B, L] column equals the status quo's decode (the probe's assert)
    assert torch.equal(p48.direct_full(got), p48.status_quo(w))


def test_l4_pack_library_equals_kern_direct():
    """The library call timed beside l4_pack (one strided copy) computes
    the probe's rows too, and tells the byte lanes apart."""
    w = p47.words((2, 3, 128, LANE), seed=6)
    NWS, M, Lx, _ = w.shape
    kern = _load("probe_tpu48.py", "kern_direct", M=M, L4=Lx // 4, LANE=LANE)
    call = pl.pallas_call(
        kern, grid=(NWS,),
        in_specs=[pl.BlockSpec((1, M, Lx, LANE), lambda b: (b, 0, 0, 0), **VMEM)],
        out_specs=pl.BlockSpec((M, 1, LANE * 4, Lx // 4), lambda b: (0, b, 0, 0), **VMEM),
        out_shape=_i32(M, NWS, LANE * 4, Lx // 4), interpret=True)
    want = np.asarray(call(jnp.asarray(w.numpy())))
    got = p48.l4_pack_library(w)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert not np.array_equal(_swap_s(got).numpy(), want)


def test_check_aligned():
    """The wrappers' alignment check: a contiguous view at an odd storage
    offset is refused (the vector loads of tile_move and field_decode)."""
    from halo2_regex_tpu_torch.ops import kernels

    flat = torch.zeros(1 + 4 * 64, dtype=torch.int32)
    base = flat[4 - flat.data_ptr() % 16 // 4:][:4 * 32]  # 16-byte aligned
    kernels._check_aligned(base, "x", 16)
    kernels._check_aligned(base[2:], "x", 8)
    for view, n in ((base[1:], 8), (base[1:], 16), (base[2:], 16), (base[3:], 4 * 2)):
        with pytest.raises(ValueError, match="aligned"):
            kernels._check_aligned(view, "x", n)


@pytest.mark.parametrize("form", p48.FORMS)
def test_l4_pack_equals_kern_mxu(mkk64, form):
    x, mkk, kerns, pmat = mkk64
    f, args = mkk(kerns["kern_mxu"], (2, 4 * LANE, 256), extra=(pmat,))
    want = np.asarray(f(*args))
    got = p48.l4_pack_plain(x.unsqueeze(0), form)  # [2, 1, 512, 256]
    assert np.array_equal(got[:, 0].numpy(), want)


# -------------------------------------------------------------- field_decode


@pytest.fixture(scope="module")
def from_batch():
    """The from: model at L=128 (the port's, and JAX's), the probes' corpus
    at B=4096, the port's witness matcher and the g4 of its front."""
    m = bp.BitplaneMatcher(p64.from_model(L), columns="witness", device="cpu")
    chars, lengths = p64.batch(B, L, torch.device("cpu"))
    g4, _fb = p68.front(m.plan, chars, lengths)
    return m, chars, lengths, g4


def _probe_names(plan, L_pad):
    G = plan.n_groups
    return dict(G=G, L_pad=L_pad, l4=L_pad // 4, NWS=B // 4096, B=B, LANE=LANE,
                fields_flat=list(plan.fields_flat), n_fields=len(plan.fields_flat), np=np)


def _g4_inputs(kind, from_batch, L_pad):
    m, chars, _lengths, g4 = from_batch
    if kind == "real":
        return g4, p64.chars_l4(chars)
    rng = np.random.default_rng(L_pad)
    g = rng.integers(-(2**31), 2**31, size=(1, 8 * m.plan.n_groups, L_pad, LANE), dtype=np.int64)
    ch = rng.integers(-(2**31), 2**31, size=(B, L_pad // 4), dtype=np.int64)
    return _t(g.astype(np.int32)), _t(ch.astype(np.int32))


def _run_probe_decode(dec, g4, ch_l4, pmat):
    NWS, G8, L_pad, _ = g4.shape
    outs = dec(jnp.asarray(g4.numpy().reshape(NWS, G8 // 8, 8, L_pad, LANE)),
               jnp.asarray(ch_l4.numpy()), pmat)
    return np.stack([np.asarray(o) for o in outs])


def _mc_from_en(out: torch.Tensor, ch_l4: torch.Tensor) -> torch.Tensor:
    """A mutation of field_decode: the masked characters from flags bit 3
    (the enable plane) in place of bit 0 (the mask)."""
    m = (out[0] >> 3) & 0x01010101
    m = m | (m << 1)
    m = m | (m << 2)
    return torch.cat([out[:-1], (ch_l4 & (m | (m << 4)))[None]])


@pytest.mark.parametrize("kind,L_pad", [("random", 128), ("random", 256), ("real", L)])
@pytest.mark.parametrize("probe", ["mxdecode", "mx", "sw"])
def test_field_decode_equals_probe(from_batch, probe, kind, L_pad):
    plan = from_batch[0].plan
    g4, ch_l4 = _g4_inputs(kind, from_batch, L_pad)
    names = _probe_names(plan, L_pad)
    if probe == "mxdecode":
        dec = _load("probe_tpu64.py", "make_mxdecode", **names)()
        pmat = _load("probe_tpu64.py", "packing_matrix", np=np)()
    else:
        dec = _load("probe_tpu68.py", "make_decode", **names)(probe)
        pmat = _load("probe_tpu68.py", "selector_matrix", np=np)()
    want = _run_probe_decode(dec, g4, ch_l4, pmat)
    fields = p64.fields_of(plan)
    for form in p64.FORMS:
        got = p64.field_decode_plain(g4, ch_l4, fields, form)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), form
        assert torch.equal(p64.field_decode(g4, ch_l4, fields, form), got)
    assert not np.array_equal(_mc_from_en(got, ch_l4).numpy(), want)


@pytest.mark.parametrize("kind,L_pad", [("random", 256), ("real", L)])
def test_field_decode_forms_equal_decode_plain(from_batch, kind, L_pad):
    """Every form is B14's function (``decode_plain`` of a kdecode plan)."""
    g4, ch_l4 = _g4_inputs(kind, from_batch, L_pad)
    kplan = bp.BitplaneMatcher(p64.from_model(L), columns="witness", emit="kdecode",
                               device="cpu").plan
    assert kplan.wgroups == from_batch[0].plan.wgroups
    want = bp.decode_plain(kplan, g4, ch_l4)  # its positions are g4's
    for form in p64.FORMS:
        assert torch.equal(p64.field_decode_plain(g4, ch_l4, p64.fields_of(kplan), form), want)


def test_torch_tails_equal_field_decode(from_batch):
    """probe_tpu64's b0 and b3 (the torch tails) on the front's g4 equal
    the decode's [B, L] columns."""
    m, chars, _lengths, g4 = from_batch
    want = p64.torch_tail(m.plan, g4, chars)
    p64.assert_same("b3", p64.torch_tail_one_transpose(m.plan, g4, chars), want)
    out = p64.field_decode_plain(g4, p64.chars_l4(chars), p64.fields_of(m.plan))
    p64.assert_same("field_decode", p64.columns_u8(out, L), want)


def test_field_decode_rejects():
    g4 = torch.zeros((1, 16, 128, LANE), dtype=torch.int32)
    ch = torch.zeros((B, 32), dtype=torch.int32)
    ok = ((0, 0, 6), (1, 0, 4))
    for args in ((g4, ch, ok, "permute"), (g4[:, :12], ch, ok, "swap"),
                 (g4, ch[:100], ok, "swap"), (g4, ch, ((2, 0, 1),), "swap"),
                 (g4, ch, ((0, 4, 5),), "swap"), (g4, ch, (), "swap")):
        with pytest.raises(ValueError):
            p64.field_decode(*args)
    with pytest.raises(ValueError):
        p64.field_decode_cuda(g4, ch, ok, "swap")  # a CPU tensor


# ------------------------------------------------------- the witness pipeline


KEYS = p68.WITNESS_KEYS


@pytest.fixture(scope="module")
def jax_witness(from_batch):
    """JAX's witness on the same batch (interpret mode), computed once."""
    _m, chars, lengths, _g4 = from_batch
    jm = JaxMatcher(jzoo.email_headers_model(max_chars_size=L, headers=("from",)),
                    columns="witness", interpret=True)
    out = jm(chars.numpy(), lengths.numpy())
    return {k: np.asarray(out[k]) for k in KEYS}


@pytest.mark.parametrize("form", p64.FORMS)
def test_witness_pipeline_equals_matcher(from_batch, form):
    m, chars, lengths, _g4 = from_batch
    got = p68.witness_pipeline(m, chars, lengths, form)
    p68.same_witness(form, got, m(chars, lengths))
    assert bool(got["match_ok"].any()) and not bool(got["match_ok"].all())


def test_witness_pipeline_equals_jax(from_batch, jax_witness):
    m, chars, lengths, _g4 = from_batch
    got = p68.witness_pipeline(m, chars, lengths, "mma_select")
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      jax_witness[k].astype(np.int64), err_msg=k)


def test_front_refuses_other_plans(from_batch):
    m, chars, lengths, _g4 = from_batch
    kd = bp.BitplaneMatcher(p64.from_model(L), columns="witness", emit="kdecode", device="cpu")
    with pytest.raises(ValueError):
        p68.front(kd.plan, chars, lengths)
    with pytest.raises(ValueError):
        p68.witness_pipeline(m, chars[:100], lengths[:100], "swap")


# ---------------------------------------------------------------- the scripts


@pytest.mark.parametrize("mod", [p47, p48, p64, p68])
def test_script_runs_plain_on_the_cpu(mod, capsys):
    assert mod.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all('"device": "cpu"' in ln for ln in lines)
