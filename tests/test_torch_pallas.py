"""The PyTorch port's table-driven matcher against the JAX package.

Each stage's plain PyTorch version (``scan_plain``, ``tag_plain``,
``fsm_plain``) is held against the JAX kernel it stands for, run in Pallas
interpret mode on the JAX matcher's own tables and the same seeded numpy
inputs: B8-B10 (``_make_scan``, ``_make_tag``, ``_make_fsm``) in batch mode
and the three B11 kernels (``_make_scan_seg``, ``_make_tag_seg``,
``_make_fsm_seg``) on one middle segment with its carries.  The whole
``RegexResult`` is held against the JAX ``PallasMatcher`` in batch mode and
segmented (``H2R_SEGMENT=16``), and for a model beyond 256 states (the
scaled-down BASELINE configs[3] of tests/test_pallas_scan.py).  Monolithic
mode's ``flat_plain`` is held against the interpret-mode B12
(``_make_flat``) on fixture models forced monolithic (one that JAX fuses
into a joint-def table, one that keeps raw bytes) and on the 40-word
dictionary model, which resolves to monolithic by itself.  All outputs
are integers or booleans: tolerance 0, dtypes included.  The CUDA kernels
are held against these same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.models.defs import AllstrRegexDef as JAllstr
from halo2_regex_tpu.models.defs import RegexDefs as JRegexDefs
from halo2_regex_tpu.ops.pallas_scan import PallasMatcher as JaxPallas

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs
from halo2_regex_tpu_torch.ops import pallas_scan as ps

from test_torch_bitplane import MAX_LEN, _build, corpus

MODELS = ["regex3", "two_def", "from", "large"]
SEG_MODELS = ["regex3", "two_def", "large"]
TB = 8  # the JAX matchers' batch tile (one interpret-mode grid step)
SEG = 16  # H2R_SEGMENT of the segmented matchers: 4 segments of L = 64
SI = 1  # the segment the B11 stage tests take (carries on both sides)
FIELDS = T.RegexResult.field_names()


def _large(pkg_allstr, pkg_defs, pkg_model, S=300, L=MAX_LEN, seed=7):
    """tests/test_pallas_scan.py's configs[3] shape scaled down: a random
    S-state table over bytes 97..102, one def, no substrings."""
    rng = np.random.default_rng(seed)
    allstr = pkg_allstr(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line = 3
    for c in range(97, 103):
        for s in range(S):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, S)))
            line += 1
    return pkg_model.from_defs([pkg_defs(allstr=allstr, substrs=[])], max_chars_size=L)


def _models(name):
    if name == "large":
        return (_large(JAllstr, JRegexDefs, J.CompiledRegexModel),
                _large(AllstrRegexDef, RegexDefs, T.CompiledRegexModel))
    return _build(J, jzoo, name), _build(T, T.zoo, name)


def _corpus(name, n, seed):
    """Seeded strings of varied lengths; for the random-table model, runs
    of its alphabet, some with a byte outside it (the dead state)."""
    if name != "large":
        return corpus(name, n, seed)
    rng = np.random.default_rng(seed)
    chars = np.zeros((n, MAX_LEN), np.uint8)
    lengths = rng.integers(0, MAX_LEN + 1, size=n).astype(np.int32)
    lengths[0] = MAX_LEN
    for i in range(n):
        chars[i] = rng.integers(97, 103, size=MAX_LEN)
        if i % 4 == 3 and lengths[i]:
            chars[i, rng.integers(0, lengths[i])] = 7
    return chars, lengths


@pytest.fixture(scope="module")
def models():
    return {n: _models(n) for n in MODELS}


def _segmented(model, jax_side):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2R_SEGMENT", str(SEG))
        if jax_side:
            return JaxPallas(model, batch_tile=TB, interpret=True, grid_mode="segmented")
        return T.PallasMatcher(model, grid_mode="segmented", device="cpu")


@pytest.fixture(scope="module")
def jax_stages(models):
    """Each model's B8-B10 intermediates from the JAX batch-mode kernels on
    one seeded 8-string batch (time-major), computed once per module."""
    out = {}
    for seed, n in enumerate(MODELS):
        jm = JaxPallas(models[n][0], batch_tile=TB, interpret=True)
        chars, lengths = _corpus(n, TB, 10 + seed)
        ctm = jnp.asarray(chars.astype(np.int32).T)
        states = jm._make_scan(TB)(jm._tables_c, jm._tables_raw, jm._tables_pair, ctm)
        ids, st, ef = jm._make_tag(TB)(states, jnp.asarray(lengths)[None, :])
        fwd, bwd = jm._make_fsm(TB)(ids, st, ef)
        out[n] = {k: np.array(v) for k, v in dict(
            chars=chars, lengths=lengths, states=states, ids=ids, start=st, endf=ef,
            fwd=fwd, bwd=bwd).items()}
    return out


@pytest.fixture(scope="module")
def ports(models):
    return {n: T.PallasMatcher(models[n][1], device="cpu") for n in MODELS}


def assert_equal(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_result_equal(got, want):
    assert isinstance(got, T.RegexResult), type(got)
    for k in FIELDS:
        assert_equal(getattr(got, k), getattr(want, k), k)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# construction: the same tables and decisions as JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_tables_match_jax_class_info(models, ports, name):
    """The port's byte -> class map is JAX's boundary-sum chain
    (cls0 + Σ Δ·(c >= b)), and its next-state rows are JAX's class table
    (``lo + 256*hi`` beyond 256 states); its pair list is JAX's."""
    jm = JaxPallas(models[name][0], batch_tile=TB, interpret=True)
    m = ports[name]
    S = m.S
    assert m.hi_lo == jm.hi_lo == (name == "large")
    for d, (use_classes, cls0, terms, tab) in enumerate(jm.class_info):
        assert use_classes
        cls = np.full(256, cls0, np.int64)
        for b_r, delta in terms:
            cls[b_r:] += delta
        np.testing.assert_array_equal(m.class_map[d].numpy(), cls)
        t = np.asarray(tab).astype(np.int64)
        want = t[:, :S] + 256 * t[:, S : 2 * S] if jm.hi_lo else t[:, :S]
        np.testing.assert_array_equal(m.next_table[d, : t.shape[0]].numpy(), want)
        # the class table is the transition table, row by row
        np.testing.assert_array_equal(
            m.next_table[d].numpy()[m.class_map[d].numpy()], models[name][1].transition[d])
        P = len(jm.pair_info[d])
        assert [tuple(r) for r in m.pairs[d, :P].tolist()] == [
            (a, b, g, int(s), int(e)) for a, b, g, s, e in jm.pair_info[d]]
        assert (m.pairs[d, P:, 0] == -1).all()


@pytest.mark.parametrize("env", [{}, {"H2R_SEGMENT": "16"}, {"H2R_SEGMENT": "48"},
                                 {"H2R_VMEM_BUDGET": "1e6"}])
@pytest.mark.parametrize("grid_mode", ["batch", "segmented"])
def test_sizing_matches_jax(models, monkeypatch, env, grid_mode):
    """mode, grid_mode (with the segmented demotion), segment and n_seg,
    and the TPU sizing (chunk, slab, scan stride) equal the JAX matcher's
    for every model, under the same environment."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for n in MODELS:
        jm = JaxPallas(models[n][0], interpret=True, grid_mode=grid_mode)
        m = T.PallasMatcher(models[n][1], grid_mode=grid_mode, device="cpu")
        assert {a: getattr(m, a) for a in SIZING} == {a: getattr(jm, a) for a in SIZING}, n


def _config3(pkg_allstr, pkg_defs, pkg_model):
    """BASELINE configs[3] as benchmarks/run_benchmarks.py:360-373 builds
    it: a 1000-state table from default_rng(0) over bytes 32..126,
    L = 65536."""
    rng = np.random.default_rng(0)
    allstr = pkg_allstr(first_state_val=0, accepted_state_val=1, largest_state_val=999)
    line = 3
    for c in range(32, 127):
        for s in range(1000):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, 1000)))
            line += 1
    return pkg_model.from_defs([pkg_defs(allstr=allstr, substrs=[])], max_chars_size=65536)


def test_config3_sizing_matches_jax():
    """The full-size large-DFA stress model: 1008 padded states, 96 byte
    classes (exactly at the boundary-term limit), no pairs, demoted to
    16 segments of 4096 as in JAX (max_pairs as the benchmark passes it)."""
    jm = JaxPallas(_config3(JAllstr, JRegexDefs, J.CompiledRegexModel), max_pairs=4096)
    m = T.PallasMatcher(_config3(AllstrRegexDef, RegexDefs, T.CompiledRegexModel),
                        max_pairs=4096, device="cpu")
    assert (m.S, m.hi_lo, m.mode, m.grid_mode, m.segment, m.n_seg, m.batch_tile) == (
        jm.S, jm.hi_lo, jm.mode, jm.grid_mode, jm.segment, jm.n_seg, jm.batch_tile) == (
        1008, True, "split", "segmented", 4096, 16, 128)
    use_classes, _cls0, terms, tab = jm.class_info[0]
    assert use_classes and len(terms) == 96 and tab.shape[0] == 96
    assert tuple(m.next_table.shape) == (1, 96, 1008) and tuple(m.pairs.shape) == (1, 0, 5)


# ---------------------------------------------------------------------------
# stage by stage: plain version vs the JAX kernel on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_scan_plain_matches_jax(ports, jax_stages, name):
    s, m = jax_stages[name], ports[name]
    out = torch.full(s["states"].shape, -7, dtype=torch.int32)
    ps.scan_plain(m.class_map, m.next_table, _t(s["chars"]), m._firsts(TB), 0, MAX_LEN, out)
    assert_equal(out, s["states"], "states")


@pytest.mark.parametrize("name", MODELS)
def test_tag_plain_matches_jax(ports, jax_stages, name):
    s, m = jax_stages[name], ports[name]
    outs = [torch.full(s["states"].shape, -7, dtype=torch.int32) for _ in range(3)]
    ps.tag_plain(_t(s["states"]), m._firsts(TB), _t(s["lengths"]), m.pairs, 0, MAX_LEN, *outs)
    for got, key in zip(outs, ("ids", "start", "endf")):
        assert_equal(got, s[key], key)
    if name in ("regex3", "two_def", "from"):
        assert s["ids"].any() and s["start"].any() and s["endf"].any()


@pytest.mark.parametrize("name", MODELS)
def test_fsm_plain_matches_jax(jax_stages, name):
    s = jax_stages[name]
    planes = [_t(s[k]) for k in ("ids", "start", "endf")]
    for reverse, key in ((False, "fwd"), (True, "bwd")):
        out = torch.full(s[key].shape, -7, dtype=torch.int32)
        ps.fsm_plain(reverse, *planes, None, None, None, 0, MAX_LEN, out)
        assert_equal(out, s[key], key)
    if name != "large":
        assert (s["fwd"] * s["bwd"]).any()


@pytest.fixture(scope="module")
def jax_seg_stages(models, jax_stages):
    """The three B11 kernels of the JAX segmented matcher on segment SI,
    their carries taken from the batch-mode intermediates (equal to what
    the segmented pipeline carries), computed once per module."""
    out = {}
    LS, q0 = SEG, SI * SEG
    for n in SEG_MODELS:
        s, jm = jax_stages[n], _segmented(models[n][0], jax_side=True)
        assert (jm.segment, jm.n_seg) == (SEG, MAX_LEN // SEG)
        st = jnp.asarray(s["states"])
        ctm = jnp.asarray(s["chars"].astype(np.int32).T)
        prev = st[:, q0 - 1, :]
        scan = jm._make_scan_seg(TB)(jm._tables_c, jm._tables_raw,
                                     jnp.concatenate([prev, ctm[q0 : q0 + LS]], 0))
        tags = jm._make_tag_seg(TB)(jnp.concatenate([prev[:, None], st[:, q0 : q0 + LS]], 1),
                                    jnp.asarray(s["lengths"] - q0)[None, :])
        ids, sta, ef = (jnp.asarray(s[k]) for k in ("ids", "start", "endf"))

        def row(a, q):
            return a[:, q : q + 1, :]

        def mask_row(vals):
            return jnp.zeros((jm.n_defs, 1, TB), jnp.int32).at[0, 0].set(vals)

        win = slice(q0, q0 + LS)
        fwd = jm._make_fsm_seg(TB, reverse=False)(
            jnp.concatenate([row(ids, q0 - 1), ids[:, win]], 1),
            jnp.concatenate([mask_row(jnp.asarray(s["fwd"][q0 - 1])), sta[:, win]], 1),
            jnp.concatenate([row(ef, q0 - 1), ef[:, win]], 1))
        bwd = jm._make_fsm_seg(TB, reverse=True)(
            jnp.concatenate([ids[:, win], row(ids, q0 + LS)], 1),
            jnp.concatenate([sta[:, win], row(sta, q0 + LS)], 1),
            jnp.concatenate([ef[:, win], mask_row(jnp.asarray(s["bwd"][q0 + LS]))], 1))
        out[n] = {k: np.array(v) for k, v in dict(
            states=scan, ids=tags[0], start=tags[1], endf=tags[2], fwd=fwd, bwd=bwd).items()}
    return out


@pytest.mark.parametrize("name", SEG_MODELS)
def test_segment_stages_match_jax(models, jax_stages, jax_seg_stages, name):
    """scan, tag and both FSMs on segment SI with explicit carries equal
    the JAX B11 kernels with their prepended/appended carry rows (and the
    batch-mode intermediates' window)."""
    s, g = jax_stages[name], jax_seg_stages[name]
    m = _segmented(models[name][1], jax_side=False)
    LS, q0 = SEG, SI * SEG
    win = slice(q0, q0 + LS)
    st = _t(s["states"])
    out = torch.full(st.shape, -7, dtype=torch.int32)
    ps.scan_plain(m.class_map, m.next_table, _t(s["chars"]), st[:, q0 - 1], q0, LS, out)
    assert_equal(out[:, win], g["states"], "states")
    np.testing.assert_array_equal(g["states"], s["states"][:, win])

    outs = [torch.full(st.shape, -7, dtype=torch.int32) for _ in range(3)]
    ps.tag_plain(st, st[:, q0 - 1], _t(s["lengths"]), m.pairs, q0, LS, *outs)
    for got, key in zip(outs, ("ids", "start", "endf")):
        assert_equal(got[:, win], g[key], key)
        np.testing.assert_array_equal(g[key], s[key][:, win])

    ids, sta, ef = (_t(s[k]) for k in ("ids", "start", "endf"))
    fwd = torch.full(_t(s["fwd"]).shape, -7, dtype=torch.int32)
    ps.fsm_plain(False, ids, sta, ef, _t(s["fwd"][q0 - 1]), ids[:, q0 - 1], ef[:, q0 - 1],
                 q0, LS, fwd)
    assert_equal(fwd[win], g["fwd"], "fwd")
    bwd = torch.full(_t(s["bwd"]).shape, -7, dtype=torch.int32)
    ps.fsm_plain(True, ids, sta, ef, _t(s["bwd"][q0 + LS]), ids[:, q0 + LS], sta[:, q0 + LS],
                 q0, LS, bwd)
    assert_equal(bwd[win], g["bwd"], "bwd")
    np.testing.assert_array_equal(g["fwd"], s["fwd"][win])
    np.testing.assert_array_equal(g["bwd"], s["bwd"][win])


# ---------------------------------------------------------------------------
# end to end: every RegexResult field and dtype vs the JAX matcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_batch_matches_jax(models, ports, name):
    """13 strings (not a multiple of the JAX batch tile, which pads to 16;
    the port does not pad), varied lengths."""
    chars, lengths = _corpus(name, 13, 20)
    want = JaxPallas(models[name][0], batch_tile=TB, interpret=True)(chars, lengths)
    got = ports[name](chars, lengths)
    assert got.states.shape == (13, models[name][1].n_defs, MAX_LEN + 1)
    assert_result_equal(got, want)
    if name == "large":
        assert got.has_dead.any() and not got.has_dead.all()


@pytest.mark.parametrize("name", SEG_MODELS)
def test_segmented_matches_jax(models, ports, name):
    """H2R_SEGMENT=16: four segments whose carries cross every boundary,
    against the JAX segmented matcher and the port's batch mode."""
    chars, lengths = _corpus(name, 13, 21)
    m = _segmented(models[name][1], jax_side=False)
    assert (m.grid_mode, m.segment, m.n_seg) == ("segmented", SEG, MAX_LEN // SEG)
    got = m(chars, lengths)
    assert_result_equal(got, _segmented(models[name][0], jax_side=True)(chars, lengths))
    assert_result_equal(got, ports[name](chars, lengths).map(lambda v: v.numpy()))
    if name != "large":
        # a masked substring crosses a segment boundary
        cross = (got.mask[:, SEG - 1 :: SEG][:, :-1] & got.mask[:, SEG::SEG]).any()
        assert bool(cross)


def test_scan_states_tm_matches_jax(models):
    """Per-string random initial states, time-major int32 characters."""
    jm = _segmented(models["large"][0], jax_side=True)
    m = _segmented(models["large"][1], jax_side=False)
    chars, _lengths = _corpus("large", TB, 22)
    ctm = chars.astype(np.int32).T.copy()
    init = np.random.default_rng(23).integers(0, 300, size=(1, TB)).astype(np.int32)
    want = np.array(jm.scan_states_tm(jnp.asarray(ctm), jnp.asarray(init), TB))
    got = m.scan_states_tm(ctm, init, TB)
    assert_equal(got, want, "states")
    with pytest.raises(ValueError, match="segmented"):
        T.PallasMatcher(models["large"][1], device="cpu").scan_states_tm(ctm, init, TB)


def test_match_one_matches_oracle(models):
    m = T.PallasMatcher(models["regex3"][1], device="cpu")
    row = m.match_one(b"from:alice@gmail.com\r\n")
    o = T.match_substrs(models["regex3"][1].regex_defs, b"from:alice@gmail.com\r\n", MAX_LEN)
    assert bool(row.match_ok)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(row, k)).astype(np.int64),
                                      np.asarray(getattr(o, k)).astype(np.int64), err_msg=k)


# ---------------------------------------------------------------------------
# what the port refuses, and where it runs
# ---------------------------------------------------------------------------


# name -> (model, constructor kwargs, H2R_SEGMENT or None): every setting
# the JAX matcher accepts beyond the defaults, as tests/test_pallas_scan.py
# runs them (chunk=16 with take_along, int8 tables on a split model and on
# the segmented >256-state path) and each TPU lowering alone
SETTINGS = {
    "monolithic": ("regex3", dict(mode="monolithic"), None),
    "max_pairs": ("regex3", dict(max_pairs=1), None),
    "vpu": ("regex3", dict(compute="vpu"), None),
    "int8": ("regex3", dict(table_dtype="int8"), None),
    "take_along": ("regex3", dict(extract="take_along"), None),
    "chunk16_take_along": ("regex3", dict(chunk=16, extract="take_along"), None),
    "slab4": ("two_def", dict(slab=4), None),
    "int8_split": ("two_def", dict(mode="split", table_dtype="int8", chunk=128), None),
    "int8_segmented_hi_lo": ("large", dict(grid_mode="segmented", table_dtype="int8",
                                           chunk=16, slab=2), SEG),
    "monolithic_vpu_take_along": ("regex3", dict(mode="monolithic", compute="vpu",
                                                 extract="take_along", slab=4), None),
}
SIZING = ("mode", "grid_mode", "chunk", "slab", "n_slab", "slab_seg", "scan_stride", "segment",
          "n_seg", "batch_tile", "extract", "compute", "table_dtype")


def _with_settings(models, name, jax_side):
    key, kw, seg = SETTINGS[name]
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setenv("H2R_SEGMENT", str(seg))
        if jax_side:
            return JaxPallas(models[key][0], batch_tile=TB, interpret=True, **kw)
        return T.PallasMatcher(models[key][1], batch_tile=TB, device="cpu", **kw)


@pytest.fixture(scope="module")
def setting_results(models):
    """Each setting's JAX RegexResult on one seeded 8-string batch (the
    interpret-mode kernels take seconds a call: computed once per module)."""
    out = {}
    for i, name in enumerate(SETTINGS):
        chars, lengths = _corpus(SETTINGS[name][0], TB, 30 + i)
        out[name] = (chars, lengths, _with_settings(models, name, jax_side=True)(chars, lengths))
    return out


@pytest.mark.parametrize("name", ["monolithic", "max_pairs", "vpu", "int8", "take_along"])
def test_unported_settings_raise(models, setting_results, name):
    """Settings the port once refused run: the monolithic mode (B12),
    asked for or resolved by ``auto`` beyond ``max_pairs``, and the TPU
    lowerings ``compute="vpu"``, ``table_dtype="int8"`` and
    ``extract="take_along"``, each equal to the JAX matcher with the same
    argument on every field and dtype."""
    m = _with_settings(models, name, jax_side=False)
    chars, lengths, want = setting_results[name]
    assert m.mode == ("monolithic" if name in ("monolithic", "max_pairs") else "split")
    assert_result_equal(m(chars, lengths), want)


@pytest.mark.parametrize("name", [n for n in SETTINGS if n not in (
    "monolithic", "max_pairs", "vpu", "int8", "take_along")])
def test_settings_match_jax(models, setting_results, name):
    """chunk, slab and the lowerings together, on split, segmented
    (>256 states) and monolithic models: the port's sizing attributes and
    its RegexResult equal the JAX matcher's with the same arguments."""
    m = _with_settings(models, name, jax_side=False)
    jm = _with_settings(models, name, jax_side=True)
    assert {a: getattr(m, a) for a in SIZING} == {a: getattr(jm, a) for a in SIZING}
    chars, lengths, want = setting_results[name]
    assert_result_equal(m(chars, lengths), want)


def test_refusals_match_jax(models):
    for kw, match in ((dict(grid_mode="chunked"), "chunked"),
                      (dict(mode="split", max_pairs=1), "split mode needs")):
        with pytest.raises(ValueError, match=match):
            JaxPallas(models["regex3"][0], interpret=True, **kw)
        with pytest.raises(ValueError, match=match):
            T.PallasMatcher(models["regex3"][1], device="cpu", **kw)
    with pytest.raises(ValueError, match="need mode='split'"):
        T.PallasMatcher(models["large"][1], mode="monolithic", device="cpu")


@pytest.mark.parametrize("kw", [dict(chunk=128), dict(slab=4), dict(chunk=0),
                                dict(chunk=0, grid_mode="segmented"), dict(slab=0)])
def test_tpu_blocking_factors_raise(models, kw):
    """``chunk`` and ``slab`` only block the TPU kernels: the port takes
    every value JAX takes, sizes ``chunk``, ``slab``, ``n_slab``,
    ``slab_seg`` and ``scan_stride`` from them as JAX does, and raises
    where JAX raises, with its exception type (a zero chunk in segmented
    mode, a zero slab)."""
    for n in MODELS:
        try:
            jm = JaxPallas(models[n][0], interpret=True, **kw)
        except Exception as e:  # noqa: BLE001 -- the port must raise the same type
            with pytest.raises(type(e)):
                T.PallasMatcher(models[n][1], device="cpu", **kw)
            continue
        m = T.PallasMatcher(models[n][1], device="cpu", **kw)
        assert {a: getattr(m, a) for a in SIZING} == {a: getattr(jm, a) for a in SIZING}, n


def test_table_tag_refuses_lists_beyond_shared_memory():
    """The tag kernel stages at most ``TABLE_TAG_SMEM_PAIRS`` pairs of a
    def's list in shared memory and reads the rest from global memory:
    a longer list is no longer refused, so the wrapper goes on to its
    device checks (meta tensors are not CUDA tensors)."""
    from halo2_regex_tpu_torch.ops import kernels

    n = kernels.TABLE_TAG_SMEM_PAIRS + 1
    st = torch.empty((1, MAX_LEN, TB), dtype=torch.int32, device="meta")
    pairs = torch.empty((1, n, ps.PAIR_FIELDS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.table_tag_cuda(st, st[:, 0], st[0, 0], pairs, 0, MAX_LEN, st, st, st)


def test_matchers_default_to_the_card(models):
    """With no device, both matchers run on the card: they land there when
    CUDA is present and raise where it is absent (nothing is replaced)."""
    for cls in (T.BitplaneMatcher, T.PallasMatcher):
        if torch.cuda.is_available():
            assert cls(models["regex3"][1]).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cls(models["regex3"][1])


def test_stage_on_unsupported_device_raises(ports):
    m = ports["regex3"]
    x = torch.empty((TB, MAX_LEN), dtype=torch.uint8, device="meta")
    out = torch.empty((1, MAX_LEN, TB), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ps.scan(m.class_map, m.next_table, x, m._firsts(TB), 0, MAX_LEN, out)


# ---------------------------------------------------------------------------
# monolithic mode: the flat stage (B12)
# ---------------------------------------------------------------------------

# name -> (JAX/port model key, constructor kwargs): regex3 forced
# monolithic; two_def, whose two defs JAX fuses into one joint-def table;
# regex3 with raw bytes (no byte classes: K = 256); the 40-word dictionary,
# monolithic by itself (211 pairs > max_pairs)
FLAT = {
    "regex3": ("regex3", dict(mode="monolithic")),
    "two_def": ("two_def", dict(mode="monolithic")),
    "raw": ("regex3", dict(mode="monolithic", max_boundary_terms=0)),
    "dict40": ("dict40", {}),
}


def _dict40():
    cfg = T.zoo.dictionary_config(40, max_byte_size=MAX_LEN)
    return (J.CompiledRegexModel.from_decomposed([J.DecomposedRegexConfig.from_json(cfg)],
                                                 max_chars_size=MAX_LEN),
            T.zoo.dictionary_model(40, max_chars_size=MAX_LEN))


def _dict_corpus(n, seed):
    """Random lowercase strings of varied lengths, with ``tag:<word>\r\n``
    (a match) in every other string and a word with a wrong ending in
    every fourth."""
    rng = np.random.default_rng(seed)
    words = T.zoo.dictionary_config()["parts"][1]["regex_def"][1:-1].split("|")
    chars = rng.integers(97, 123, size=(n, MAX_LEN)).astype(np.uint8)
    lengths = rng.integers(0, MAX_LEN + 1, size=n).astype(np.int32)
    for i in range(0, n, 2):
        s = b"tag:" + words[int(rng.integers(0, len(words)))].encode()
        s += b"\r\n" if i % 4 == 0 else b"\r"
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@pytest.fixture(scope="module")
def flat_models(models):
    out = {"dict40": _dict40()}
    out.update({k: models[k] for k in ("regex3", "two_def")})
    return out


def _flat_corpus(name, n, seed):
    return _dict_corpus(n, seed) if name == "dict40" else _corpus(FLAT[name][0], n, seed)


@pytest.mark.parametrize("name", list(FLAT))
def test_flat_plain_matches_jax(flat_models, name):
    """flat_plain's six planes against the interpret-mode JAX flat kernel
    on its own tables, 8 strings."""
    key, kw = FLAT[name]
    jmodel, tmodel = flat_models[key]
    jm = JaxPallas(jmodel, batch_tile=TB, interpret=True, **kw)
    m = T.PallasMatcher(tmodel, device="cpu", **kw)
    assert jm.mode == m.mode == "monolithic"
    assert jm.fuse_defs == (name == "two_def")
    assert jm._raw_needed == (name == "raw") == (m.flat_table.shape[1] == 256)
    chars, lengths = _flat_corpus(name, TB, 31)
    want = jm._make_flat(TB)(jm._tables_c, jm._tables_raw, jm._tables_joint,
                             jnp.asarray(chars.astype(np.int32).T), jnp.asarray(lengths)[None, :])
    outs = [torch.full(np.shape(w), -7, dtype=torch.int32) for w in want]
    ps.flat_plain(m.class_map, m.flat_table, m.first_states, _t(chars), _t(lengths), *outs)
    for got, w, key in zip(outs, want, ("states", "ids", "start", "endf", "fwd", "bwd")):
        assert_equal(got, w, key)
    if name != "two_def":
        assert (np.asarray(want[4]) * np.asarray(want[5])).any()  # the mask lights up


@pytest.mark.parametrize("name", list(FLAT))
def test_monolithic_matches_jax(flat_models, name):
    """Every RegexResult field and dtype against the JAX monolithic
    matcher, 13 strings (the JAX side pads to 16)."""
    key, kw = FLAT[name]
    jmodel, tmodel = flat_models[key]
    chars, lengths = _flat_corpus(name, 13, 32)
    want = JaxPallas(jmodel, batch_tile=TB, interpret=True, **kw)(chars, lengths)
    got = T.PallasMatcher(tmodel, device="cpu", **kw)(chars, lengths)
    assert_result_equal(got, want)
    if name in ("regex3", "dict40"):
        assert got.match_ok.any() and got.all_substr_ids.any()


def test_dict40_sizing_and_backends_agree(flat_models):
    """The dictionary model at L=64: s_pad 184 and 211 pairs, so ``auto``
    resolves to monolithic with the JAX matcher's batch tile and grid
    mode (monolithic stays ``batch`` at any L); the bit-sliced matcher
    and the split matcher (``max_pairs=4096``) give the same RegexResult."""
    jmodel, tmodel = flat_models["dict40"]
    m = T.PallasMatcher(tmodel, device="cpu")
    jm = JaxPallas(jmodel, interpret=True)
    assert (m.S, [len(p) for p in m.pair_info]) == (jm.S, [len(p) for p in jm.pair_info]) == (
        184, [211])
    assert (m.mode, m.grid_mode, m.batch_tile) == (jm.mode, jm.grid_mode, jm.batch_tile) == (
        "monolithic", "batch", 1024)
    chars, lengths = _dict_corpus(40, 33)
    got = m(chars, lengths)
    assert_result_equal(got, T.PallasMatcher(tmodel, max_pairs=4096, device="cpu")(
        chars, lengths).map(lambda v: v.numpy()))
    assert_result_equal(got, T.BitplaneMatcher(tmodel, compact=False, device="cpu")(
        chars, lengths).map(lambda v: v.numpy()))
    assert int(got.match_ok.sum()) == 10


def test_flat_smem_sizing():
    """The flat kernel stages its packed table in shared memory when it
    fits the card's opt-in limit (227 KiB on the H100): the dictionary
    model's 32 x 184 table does; a raw-bytes def (K = 256) at S = 256 does
    not, and its wrapper sends it to global memory (smem bytes 0)."""
    from halo2_regex_tpu_torch.ops import kernels

    optin = 232448
    assert kernels.flat_smem_bytes(1, 32, 184, optin) == 4 * 32 * 184
    assert kernels.flat_smem_bytes(1, 256, 256, optin) == 0
    assert kernels.flat_smem_bytes(2, 128, 256, optin) == 0
