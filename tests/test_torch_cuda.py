"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On a machine with an
NVIDIA GPU and nvcc, run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax, which the GPU
machine need not have; this file imports no JAX.)  Bit-exact: integer
outputs, tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops import kernels

from fixtures import CONFIGS

pytestmark = pytest.mark.cuda

MAX_LEN = 64
MODELS = ["regex3", "two_def", "from"]
PIECES = [b"from:", b"@", b".", b"<", b">", b"\r\n", b"ab", b"x.y", b"gmail.com",
          b"email was meant for @", b" Also for ", b"abc"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _model(name, L=MAX_LEN):
    if name == "from":
        return T.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    cfgs = ["regex1", "regex2"] if name == "two_def" else [name]
    return T.CompiledRegexModel.from_decomposed(
        [T.DecomposedRegexConfig.from_json(CONFIGS[c]) for c in cfgs], max_chars_size=L
    )


def _corpus(n, L, seed):
    rng = np.random.default_rng(seed)
    chars = np.zeros((n, L), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i in range(n):
        if i % 5 == 0:
            s = rng.integers(0, 256, size=int(rng.integers(0, L + 1))).astype(np.uint8).tobytes()
        else:
            s = b"".join(PIECES[j] for j in rng.integers(0, len(PIECES), size=int(rng.integers(0, 9))))
        s = s[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@pytest.mark.parametrize("name", MODELS)
def test_kernels_match_plain(dev, name):
    m = T.BitplaneMatcher(_model(name), columns="witness", device=dev)
    plan = m.plan
    chars, lengths = _corpus(8192, MAX_LEN, 1)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    bits, en = bp.qpack_plain(plan, ch, lw)
    kb, ke = kernels.qpack_cuda(plan, ch, lw)
    assert torch.equal(kb, bits) and torch.equal(ke, en)
    logs = bp.scan_plain(plan, bits)
    assert torch.equal(kernels.scan_cuda(plan, bits), logs)
    g4, fb = bp.post_plain(plan, logs, en)
    kg, kf = kernels.post_cuda(plan, logs, en)
    assert torch.equal(kg, g4) and torch.equal(kf, fb)


def test_qpack_byte_path_matches_plain(dev):
    """K1 stages the input with 32-bit loads when it can; a chars tensor
    at an odd address takes the byte-load path, same result."""
    m = T.BitplaneMatcher(_model("from"), columns="witness", device=dev)
    chars, lengths = _corpus(4096, MAX_LEN, 3)
    buf = torch.zeros(chars.size + 1, dtype=torch.uint8, device=dev)
    ch = buf[1:].view(chars.shape)
    ch.copy_(torch.from_numpy(chars))
    assert ch.data_ptr() % 4 != 0
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    want = bp.qpack_plain(m.plan, ch, lw)
    got = kernels.qpack_cuda(m.plan, ch, lw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("two_def", MAX_LEN), ("from", MAX_LEN),
                                    ("regex3", 200), ("from", 1000)])
def test_serving_kernels_match_plain(dev, name, L):
    """pack_raw (B5), post_planes (B3 planes mode) and fb_only (B4)
    against their plain versions, at L == L_pad and at L_pad > L."""
    model = _model(name, L)
    full, match = (bp.make_plan(model, c) for c in ("full", "match"))
    chars, lengths = _corpus(8192, L, 4)
    quads = bp.raw_quads(torch.from_numpy(chars).to(dev), full.L_pad)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    bits, en = bp.pack_plain(full, quads, lw)
    kb, ke = kernels.pack_raw_cuda(full, quads, lw)
    assert torch.equal(kb, bits) and torch.equal(ke, en)
    logs = kernels.scan_cuda(full, bits)
    assert torch.equal(kernels.post_planes_cuda(full, logs, en), bp.post_planes_plain(full, logs, en))
    assert torch.equal(kernels.fb_only_cuda(match, logs, en), bp.fb_only_plain(match, logs, en))


def _assert_same(got, want):
    if isinstance(want, T.RegexResult):
        got, want = vars(got), vars(want)
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("columns", ["witness", "full", "match"])
@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("from", 40), ("from", 1024),
                                    ("from", 1000)])
def test_matcher_on_card_matches_cpu(dev, columns, name, L):
    """Each column set's result on the card equals the CPU (plain) run,
    including a ragged batch (4099), lengths that are not a multiple of
    the pack kernel's 32-position tile, and L_pad > L; the path's kernels
    launch as ``path_launches`` says (once each, three for a chunked
    post), and no other kernel does."""
    model = _model(name, L)
    chars, lengths = _corpus(4099, L, 2)
    m = T.BitplaneMatcher(model, columns=columns, device=dev)
    kernels.reset_launch_counts()
    got = m(chars, lengths)
    torch.cuda.synchronize()
    launches = kernels.path_launches(m.plan)
    assert {k.name: k.launches for k in kernels.KERNELS} == {
        k.name: launches.get(k, 0) for k in kernels.KERNELS}
    _assert_same(got, T.BitplaneMatcher(model, columns=columns, device="cpu")(chars, lengths))


def test_extract_runs_on_card_matches_cpu(dev):
    model = _model("two_def")
    chars, lengths = _corpus(4099, MAX_LEN, 6)
    res = T.BitplaneMatcher(model, device=dev)(chars, lengths)
    got = T.extract_runs(res.all_substr_ids, res.masked_characters, max_len=32)
    want = T.extract_runs(res.all_substr_ids.cpu(), res.masked_characters.cpu(), max_len=32)
    _assert_same(got, want)


def test_wrapper_rejects_bad_inputs(dev):
    m = T.BitplaneMatcher(_model("regex3"), columns="witness", device=dev)
    ch = torch.zeros((4096, MAX_LEN), dtype=torch.uint8, device=dev)
    lw = torch.zeros((1, 128, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        kernels.qpack_cuda(m.plan, ch, lw.to(torch.int64))
    with pytest.raises(ValueError, match="B %"):
        kernels.qpack_cuda(m.plan, ch[:100], lw)
    # NWS = 2: with a size-1 dim the permuted view would count as contiguous
    bits = torch.zeros((2, MAX_LEN, m.plan.kp, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scan_cuda(m.plan, bits.permute(1, 2, 0, 3))
    with pytest.raises(ValueError, match="shape"):
        kernels.fb_only_cuda(m.plan, torch.zeros((1, m.plan.sb_sum, 8, 128), dtype=torch.int32,
                                                 device=dev), lw[:, :8])


# ---------------------------------------------------------------------------
# the table-driven split matcher (PallasMatcher): B8-B11
# ---------------------------------------------------------------------------


def _large_model(S=300, L=MAX_LEN, seed=7):
    """A random S-state table over bytes 97..102 (more than 256 states)."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs

    rng = np.random.default_rng(seed)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line = 3
    for c in range(97, 103):
        for s in range(S):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, S)))
            line += 1
    return T.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[])],
                                          max_chars_size=L)


def _table_model(name):
    return _large_model() if name == "large" else _model(name)


def _table_corpus(name, n, seed, L=MAX_LEN):
    """``_corpus`` with a sender line in every third string (so the
    from: models' ids and masks light up); random bytes of the table's
    alphabet for the large model."""
    chars, lengths = _corpus(n, L, seed)
    rng = np.random.default_rng(seed)
    if name == "large":
        chars = rng.integers(97, 103, size=(n, L)).astype(np.uint8)
        chars[::5, 3] = 7  # a byte outside the alphabet: the dead state
        return chars, lengths
    for i in range(1, n, 3):
        user = bytes(rng.choice(list(b"abcxyz."), size=int(rng.integers(1, 8))).astype(np.uint8))
        s = (b"ab c" * int(rng.integers(0, 3)) + b"\r\nfrom:" + (b"Al <" if i % 2 else b"")
             + user + b"@gmail.com" + (b">" if i % 2 else b"") + b"\r\n")[:L]
        chars[i] = 0
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("name", ["regex3", "two_def", "from", "large"])
def test_table_kernels_match_plain(dev, monkeypatch, name, smem):
    """The three table kernels against their plain versions over the whole
    L (batch mode) and on a middle window with carries (segmented), with
    the next-state table in shared memory and read from global memory; the
    scan in its serial form and in chunks of 16 with warm-ups of 0 and 8,
    the FSMs in one pass and in chunks of 5 and 64."""
    from halo2_regex_tpu_torch.ops import pallas_scan as ps

    if not smem:
        monkeypatch.setattr(kernels, "table_smem_bytes", lambda K, S, d: 0)
    m = T.PallasMatcher(_table_model(name), device=dev)
    chars, lengths = _table_corpus(name, 4099, 7)
    ch = torch.from_numpy(chars).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    B = ch.shape[0]
    shape = (m.n_defs, MAX_LEN, B)

    def planes(n):
        return [torch.full(shape, -7, dtype=torch.int32, device=dev) for _ in range(n)]

    st_p = planes(1)[0]
    ps.scan_plain(m.class_map, m.next_table, ch, m._firsts(B), 0, MAX_LEN, st_p)
    q0, LS = 16, 32  # a window with carries on both sides
    for form in ((0, 0), (16, 0), (16, 8)):
        st_k = planes(1)[0]
        kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(B), 0, MAX_LEN, st_k,
                                next16=m.next_table16, form=form)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p), form
        st_w = planes(1)[0]
        kernels.table_scan_cuda(m.class_map, m.next_table, ch, st_p[:, q0 - 1], q0, LS, st_w,
                                form=form)
        assert torch.equal(st_w[:, q0 : q0 + LS], st_p[:, q0 : q0 + LS]), form
        assert bool((st_w[:, :q0] == -7).all() and (st_w[:, q0 + LS :] == -7).all())

    want, got = planes(3), planes(3)
    ps.tag_plain(st_p, m._firsts(B), ln, m.pairs, 0, MAX_LEN, *want)
    kernels.table_tag_cuda(st_p, m._firsts(B), ln, m.pairs, 0, MAX_LEN, *got)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    win = planes(3)
    kernels.table_tag_cuda(st_p, st_p[:, q0 - 1], ln, m.pairs, q0, LS, *win)
    for a, b in zip(win, want):
        assert torch.equal(a[:, q0 : q0 + LS], b[:, q0 : q0 + LS])

    ids, sta, ef = want
    f_p = torch.full((MAX_LEN, B), -7, dtype=torch.int32, device=dev)
    b_p = f_p.clone()
    ps.fsm_plain(False, ids, sta, ef, None, None, None, 0, MAX_LEN, f_p)
    ps.fsm_plain(True, ids, sta, ef, None, None, None, 0, MAX_LEN, b_p)
    carry_f = (f_p[q0 - 1], ids[:, q0 - 1], ef[:, q0 - 1])
    carry_b = (b_p[q0 + LS], ids[:, q0 + LS], sta[:, q0 + LS])
    for cl in (0, 5, 64):
        for reverse, want_f, carry in ((False, f_p, carry_f), (True, b_p, carry_b)):
            f_k = torch.full_like(f_p, -7)
            kernels.table_fsm_cuda(reverse, ids, sta, ef, None, None, None, 0, MAX_LEN, f_k,
                                   cl=cl)
            assert torch.equal(f_k, want_f), (cl, reverse)
            f_w = torch.full_like(f_p, -7)
            kernels.table_fsm_cuda(reverse, ids, sta, ef, *carry, q0, LS, f_w, cl=cl)
            assert torch.equal(f_w[q0 : q0 + LS], want_f[q0 : q0 + LS]), (cl, reverse)
        both = torch.full_like(f_p, -7), torch.full_like(f_p, -7)
        kernels.table_fsms_cuda(ids, sta, ef, q0, LS, *both, fwd_carry=carry_f,
                                bwd_carry=carry_b, cl=cl)
        assert torch.equal(both[0][q0 : q0 + LS], f_p[q0 : q0 + LS])
        assert torch.equal(both[1][q0 : q0 + LS], b_p[q0 : q0 + LS])
        assert bool((both[0][:q0] == -7).all() and (both[1][q0 + LS :] == -7).all())


@pytest.mark.parametrize("permutation", [False, True])
def test_chunked_scan_long_strings(dev, permutation):
    """The chunked scan where the matcher picks it (64 strings, L = 32768):
    a random 1000-state table, and one whose every byte permutes the states
    (it never resyncs, so the repair walks every speculative chunk), equal
    to the serial scan, with the repair count of ``scan_chunks_plain``."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs
    from halo2_regex_tpu_torch.ops import pallas_scan as ps

    S, L, B = 1000, 32768, 64
    rng = np.random.default_rng(11)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line = 3
    for c in range(32, 127):
        nxt = rng.permutation(S) if permutation else rng.integers(0, S, size=S)
        for s_ in range(S):
            allstr.state_lookup[(c, s_)] = (line, int(nxt[s_]))
            line += 1
    model = T.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[])],
                                           max_chars_size=L)
    m = T.PallasMatcher(model, max_pairs=4096, device=dev)
    assert kernels.table_scan_form(1, B, L, dev)[0] > 0
    ch = torch.from_numpy(rng.integers(32, 127, size=(B, L)).astype(np.uint8)).to(dev)
    want = torch.empty((1, L, B), dtype=torch.int32, device=dev)
    kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(B), 0, L, want,
                            form=(0, 0))
    C, W = kernels.table_scan_form(1, B, L, dev)
    twin = torch.full_like(want, -7)
    n_twin = ps.scan_chunks_plain(m.class_map, m.next_table, ch, m._firsts(B), 0, L, C, W, twin)
    assert torch.equal(twin, want)
    before = kernels.table_scan_repaired(dev)
    got = torch.full_like(want, -7)
    kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(B), 0, L, got,
                            next16=m.next_table16)
    assert torch.equal(got, want)
    assert kernels.table_scan_repaired(dev) - before == n_twin
    if permutation:
        assert n_twin > 0.99 * B * (L - W - C)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("name", ["regex3", "two_def", "from", "large"])
def test_pallas_matcher_on_card_matches_cpu(dev, monkeypatch, name, segmented):
    """The matcher on the card equals the CPU (plain) run on every field
    and dtype, for a ragged batch, chars at an odd address (byte loads),
    in batch mode and over 4 segments (the CPU runs them; the card runs one
    pass over [0, L)), with the launches ``table_path_launches`` names and
    no other kernel."""
    model = _table_model(name)
    if segmented:
        monkeypatch.setenv("H2R_SEGMENT", "16")
    kw = dict(grid_mode="segmented") if segmented else {}
    m = T.PallasMatcher(model, device=dev, **kw)
    chars, lengths = _table_corpus(name, 4099, 8)
    for odd in (False, True):
        ch = torch.from_numpy(chars).to(dev)
        if odd:
            buf = torch.zeros(chars.size + 1, dtype=torch.uint8, device=dev)
            ch = buf[1:].view(chars.shape)
            ch.copy_(torch.from_numpy(chars))
        kernels.reset_launch_counts()
        got = m(ch, torch.from_numpy(lengths).to(dev))
        torch.cuda.synchronize()
        want_counts = {k.name: 0 for k in kernels.KERNELS}
        want_counts.update({k.name: v for k, v in kernels.table_path_launches(m, 4099).items()})
        assert {k.name: k.launches for k in kernels.KERNELS} == want_counts
        _assert_same(got, T.PallasMatcher(model, device="cpu", **kw)(chars, lengths))


@pytest.mark.parametrize("name", ["from", "large"])
def test_pallas_matcher_short_segments_on_card(dev, monkeypatch, name):
    """Segments of 8 positions, shorter than one 16-byte load: the CPU runs
    them, the card one pass over [0, L), and the results are equal."""
    monkeypatch.setenv("H2R_SEGMENT", "8")
    model = _table_model(name)
    m = T.PallasMatcher(model, grid_mode="segmented", device=dev)
    assert m.segment == 8
    chars, lengths = _table_corpus(name, 300, 10)
    got = m(torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev))
    _assert_same(got, T.PallasMatcher(model, grid_mode="segmented", device="cpu")(
        chars, lengths))


def test_pallas_scan_states_tm_on_card(dev, monkeypatch):
    monkeypatch.setenv("H2R_SEGMENT", "16")
    model = _large_model()
    chars, _ = _table_corpus("large", 300, 9)
    ctm = chars.astype(np.int32).T.copy()
    init = np.random.default_rng(3).integers(0, 300, size=(1, 300)).astype(np.int32)
    got = T.PallasMatcher(model, grid_mode="segmented", device=dev).scan_states_tm(ctm, init, 300)
    want = T.PallasMatcher(model, grid_mode="segmented", device="cpu").scan_states_tm(
        ctm, init, 300)
    assert torch.equal(got.cpu(), want)


def test_table_wrappers_reject_bad_inputs(dev):
    m = T.PallasMatcher(_model("regex3"), device=dev)
    ch = torch.zeros((64, MAX_LEN), dtype=torch.uint8, device=dev)
    out = torch.zeros((1, MAX_LEN, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="window"):
        kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(64), 60, 8, out)
    with pytest.raises(ValueError, match="int32"):
        kernels.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(64).long(), 0, 8, out)
    with pytest.raises(ValueError, match="together"):
        kernels.table_fsm_cuda(False, out, out, out, None, out[:, 0], None, 0, 8, out[0])


# ---------------------------------------------------------------------------
# the tiled input contract (B6 tpack, B3's tiled mode) and the monolithic
# table kernel (B12 table_flat)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("two_def", MAX_LEN), ("from", MAX_LEN),
                                    ("from", 1000)])
def test_tiled_kernels_match_plain(dev, name, L):
    """tpack and the post kernel's tiled mode against their plain versions
    on 8192 strings (NWS = 2), at L == L_pad and at L_pad > L."""
    model = _model(name, L)
    plan = bp.make_plan(model, "witness", tiled=True)
    chars, lengths = _corpus(8192, L, 11)
    tiled = torch.from_numpy(bp.tile_corpus(chars, plan.L_pad)).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    bits, en = bp.tpack_plain(plan, tiled, lw)
    kb, ke = kernels.tpack_cuda(plan, tiled, lw)
    assert torch.equal(kb, bits) and torch.equal(ke, en)
    logs = kernels.scan_cuda(plan, bits)
    g4, fb = bp.post_plain(plan, logs, en, tiled)
    kg, kf = kernels.post_tiled_cuda(plan, logs, en, tiled)
    assert torch.equal(kg, g4) and torch.equal(kf, fb)


@pytest.mark.parametrize("columns", ["witness", "match"])
@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("two_def", MAX_LEN), ("from", 1000)])
def test_tiled_matcher_on_card_matches_cpu(dev, columns, name, L):
    """The tiled matcher on the card equals the CPU run and the [B, L]
    matcher, for lengths shorter than the tiled batch; tpack, the scan and
    the tail launch once each, and no other kernel does."""
    model = _model(name, L)
    chars, lengths = _corpus(4099, L, 12)
    m = T.BitplaneMatcher(model, columns=columns, input_layout="tiled", device=dev)
    tiled = bp.tile_corpus(chars, m.L_pad)
    kernels.reset_launch_counts()
    got = m(tiled, lengths)
    torch.cuda.synchronize()
    launches = kernels.path_launches(m.plan)
    assert {k.name for k in launches} == {"tpack", "scan",
                                          "post_tiled" if columns == "witness" else "fb_only"}
    assert {k.name: k.launches for k in kernels.KERNELS} == {
        k.name: launches.get(k, 0) for k in kernels.KERNELS}
    _assert_same(got, T.BitplaneMatcher(model, columns=columns, input_layout="tiled",
                                        device="cpu")(tiled, lengths))
    _assert_same(got, T.BitplaneMatcher(model, columns=columns, device="cpu")(chars, lengths))


def _dict_model(L=MAX_LEN):
    return T.zoo.dictionary_model(40, max_chars_size=L)


def _flat_case(name, L=MAX_LEN):
    """(model, PallasMatcher kwargs) of the monolithic cases: fixture
    models forced monolithic, the 40-word dictionary (auto resolves to
    monolithic) and a raw-bytes 256-state table (K = 256, read from global
    memory)."""
    if name == "dict40":
        return _dict_model(L), {}
    if name == "raw256":
        return _large_model(S=250, L=L), dict(mode="monolithic", max_boundary_terms=0)
    return _model(name, L), dict(mode="monolithic")


def _flat_corpus(name, n, seed, L=MAX_LEN):
    if name == "raw256":
        return _table_corpus("large", n, seed, L)
    chars, lengths = _table_corpus("from" if name != "dict40" else "regex3", n, seed, L)
    if name == "dict40":  # tag:<word>\r\n in every third string
        words = T.zoo.dictionary_config()["parts"][1]["regex_def"][1:-1].split("|")
        rng = np.random.default_rng(seed)
        for i in range(0, n, 3):
            s = b"tag:" + words[int(rng.integers(0, len(words)))].encode() + b"\r\n"
            chars[i, : len(s)] = bytearray(s)
            lengths[i] = len(s)
    return chars, lengths


@pytest.mark.parametrize("L", [MAX_LEN, 70])
@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("name", ["regex3", "two_def", "from", "dict40", "raw256"])
def test_table_flat_matches_plain(dev, monkeypatch, name, smem, L):
    """table_flat against flat_plain on 4099 strings (a ragged grid), with
    the packed table in shared memory and read from global memory, at an
    L that is a multiple of 32 (16-byte char loads) and one that is not;
    the backward pass's bit words equal flat_bits_plain's.  The raw-bytes
    256-state table does not fit shared memory and always takes the
    global path."""
    from halo2_regex_tpu_torch.ops import pallas_scan as ps

    model, kw = _flat_case(name, L)
    m = T.PallasMatcher(model, device=dev, **kw)
    assert m.mode == "monolithic"
    n_defs, K, S = m.flat_table.shape
    fits = kernels.flat_smem_bytes(n_defs, K, S, kernels._smem_optin(dev)) > 0
    assert fits == (name != "raw256")
    if not smem:
        monkeypatch.setattr(kernels, "flat_smem_bytes", lambda *a: 0)
    chars, lengths = _flat_corpus(name, 4099, 13, L)
    ch = torch.from_numpy(chars).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    B = ch.shape[0]

    def outs():
        return ([torch.full((n_defs, L, B), -7, dtype=torch.int32, device=dev)
                 for _ in range(4)]
                + [torch.full((L, B), -7, dtype=torch.int32, device=dev)
                   for _ in range(2)])

    want, got = outs(), outs()
    args = (m.class_map, m.flat_table, m.first_states, ch, ln)
    ps.flat_plain(*args, *want)
    bits = torch.full((3, -(-L // 32), B), -7, dtype=torch.int32, device=dev)
    kernels.table_flat_cuda(*args, *got, bits=bits)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(bits, ps.flat_bits_plain(*args, *outs()))
    if name != "raw256":
        assert bool((want[4] * want[5]).any())  # the mask lights up


@pytest.mark.parametrize("name", ["regex3", "two_def", "dict40", "raw256"])
def test_monolithic_matcher_on_card_matches_cpu(dev, name):
    """The monolithic matcher on the card equals the CPU run on every
    field and dtype (chars at an odd address: byte loads, too); one
    table_flat launch and no other kernel."""
    model, kw = _flat_case(name)
    m = T.PallasMatcher(model, device=dev, **kw)
    chars, lengths = _flat_corpus(name, 4099, 14)
    for odd in (False, True):
        ch = torch.from_numpy(chars).to(dev)
        if odd:
            buf = torch.zeros(chars.size + 1, dtype=torch.uint8, device=dev)
            ch = buf[1:].view(chars.shape)
            ch.copy_(torch.from_numpy(chars))
        kernels.reset_launch_counts()
        got = m(ch, torch.from_numpy(lengths).to(dev))
        torch.cuda.synchronize()
        want_counts = {k.name: 0 for k in kernels.KERNELS}
        want_counts["table_flat"] = 1
        assert {k.name: k.launches for k in kernels.KERNELS} == want_counts
        _assert_same(got, T.PallasMatcher(model, device="cpu", **kw)(chars, lengths))


# ---------------------------------------------------------------------------
# the knob variants: the pack kernels' class-stage and en_pack modes, the
# in-scan pack (B2 fused_pack), one def's scan (B7), B3's direct and
# witness-planes modes and the decode kernel (B14)
# ---------------------------------------------------------------------------


def _knobs(**kw):
    from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

    return BitplaneKnobs(**kw)


@pytest.mark.parametrize("class_stage", [False, "binary", "onehot"])
@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("two_def", MAX_LEN), ("from", 1000)])
def test_pack_modes_and_scans_match_plain(dev, name, L, class_stage):
    """qpack, pack_raw and tpack in each class-stage mode, with en_pack on
    and off; the scan on each mode's planes, and scan_def for each def
    (equal to the scan's slice)."""
    model = _model(name, L)
    chars, lengths = _corpus(8192, L, 21)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    for en_pack in (True, False):
        plan = bp.make_plan(model, "witness", knobs=_knobs(class_stage=class_stage,
                                                           en_pack=en_pack), unroll=2)
        quads = bp.raw_quads(ch, plan.L_pad)
        bits, en = bp.pack_plain(plan, quads, lw)
        assert (en is None) == (not en_pack)
        kb, ke = kernels.pack_raw_cuda(plan, quads, lw)
        assert torch.equal(kb, bits) and (ke is None if en is None else torch.equal(ke, en))
        if plan.qpack:
            kb, ke = kernels.qpack_cuda(plan, ch, lw)
            assert torch.equal(kb, bits) and (ke is None if en is None else torch.equal(ke, en))
        logs = bp.scan_plain(plan, bits)
        assert torch.equal(kernels.scan_cuda(plan, bits), logs)
        for d, c in enumerate(plan.circuits):
            got = kernels.scan_def_cuda(plan, bits, d)
            assert torch.equal(got, bp.scan_def_plain(plan, bits, d))
            assert torch.equal(got, logs[:, plan.sb_off[d]: plan.sb_off[d] + c.sb])
    tplan = bp.make_plan(model, "witness", knobs=_knobs(class_stage=class_stage), tiled=True)
    tiled = torch.from_numpy(bp.tile_corpus(chars, tplan.L_pad)).to(dev)
    kb, ke = kernels.tpack_cuda(tplan, tiled, lw)
    bits, en = bp.tpack_plain(tplan, tiled, lw)
    assert torch.equal(kb, bits) and torch.equal(ke, en)


@pytest.mark.parametrize("unroll", [1, 3, 8])
@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("from", 1000)])
def test_scan_fpack_matches_plain(dev, name, L, unroll):
    """B2's in-scan pack against its plain version, at several unrolls."""
    model = _model(name, L)
    plan = bp.make_plan(model, "witness", knobs=_knobs(fuse_pack=True, class_stage=False,
                                                       en_pack=False, qpack=False),
                        unroll=unroll)
    chars, _lengths = _corpus(8192, L, 22)
    quads = bp.raw_quads(torch.from_numpy(chars).to(dev), plan.L_pad)
    assert torch.equal(kernels.scan_fpack_cuda(plan, quads), bp.scan_fpack_plain(plan, quads))


@pytest.mark.parametrize("name,L", [("regex3", MAX_LEN), ("two_def", MAX_LEN), ("from", MAX_LEN),
                                    ("from", 1000)])
def test_emission_kernels_match_plain(dev, name, L):
    """post_direct, the post kernel's witness planes mode and the decode
    kernel (after the bytes-mode post) against their plain versions."""
    model = _model(name, L)
    chars, lengths = _corpus(8192, L, 23)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    base = bp.make_plan(model, "witness")
    bits, en = bp.pack_plain(base, bp.raw_quads(ch, base.L_pad), lw)
    logs = kernels.scan_cuda(base, bits)
    pd = bp.make_plan(model, "witness", knobs=_knobs(emit="direct"))
    assert pd.emit == "direct"
    assert torch.equal(kernels.post_direct_cuda(pd, logs, en), bp.post_direct_plain(pd, logs, en))
    pp = bp.make_plan(model, "witness", knobs=_knobs(emit="planes"))
    assert torch.equal(kernels.post_planes_cuda(pp, logs, en), bp.post_planes_plain(pp, logs, en))
    pk = bp.make_plan(model, "witness", knobs=_knobs(emit="kdecode"))
    g4, fb = kernels.post_cuda(pk, logs, en)
    want = bp.post_plain(pk, logs, en)
    assert torch.equal(g4, want[0]) and torch.equal(fb, want[1])
    chp = torch.cat([ch, ch.new_zeros((ch.shape[0], pk.L_pad - pk.L))], 1) if pk.L_pad != pk.L else ch
    ch_l4 = chp.contiguous().reshape(-1).view(torch.int32).reshape(ch.shape[0], pk.l4)
    assert torch.equal(kernels.decode_cuda(pk, g4, ch_l4), bp.decode_plain(pk, g4, ch_l4))


KNOB_CASES = [
    dict(emit="direct"), dict(emit="kdecode"), dict(emit="planes"), dict(post="xla"),
    dict(fuse_pack=True), dict(class_stage=False), dict(class_stage="onehot"),
    dict(en_pack=False), dict(qpack=False, en_pack=False, class_stage="onehot"),
    dict(unroll=1), dict(unroll=8),
]


@pytest.mark.parametrize("kw", KNOB_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("columns", ["witness", "full", "match"])
def test_knob_variants_on_card_match_cpu(dev, columns, kw):
    """Each knob variant's matcher on the card equals the CPU (plain) run
    on 4099 strings, and launches exactly its path's kernels."""
    model = _model("from", MAX_LEN)
    chars, lengths = _corpus(4099, MAX_LEN, 24)
    m = T.BitplaneMatcher(model, columns=columns, device=dev, **kw)
    kernels.reset_launch_counts()
    got = m(chars, lengths)
    torch.cuda.synchronize()
    launches = kernels.path_launches(m.plan)
    assert {k.name: k.launches for k in kernels.KERNELS} == {
        k.name: launches.get(k, 0) for k in kernels.KERNELS}
    _assert_same(got, T.BitplaneMatcher(model, columns=columns, device="cpu", **kw)(chars, lengths))


def test_scan_planes_on_card(dev):
    """``scan_planes`` (B7) of each def of the 3-def email model equals the
    fused scan's slice, with one scan_def launch per call."""
    model = T.zoo.email_headers_model(max_chars_size=MAX_LEN)
    m = T.BitplaneMatcher(model, columns="witness", device=dev)
    chars, lengths = _corpus(4096, MAX_LEN, 25)
    bits, _en = bp.qpack_plain(m.plan, torch.from_numpy(chars).to(dev),
                               bp.len_table(torch.from_numpy(lengths).to(dev)))
    logs = kernels.scan_cuda(m.plan, bits)
    for d, c in enumerate(m.plan.circuits):
        kernels.reset_launch_counts()
        got = m.scan_planes(bits, d)
        assert kernels.SCAN_DEF.launches == 1
        assert torch.equal(got, logs[:, m.plan.sb_off[d]: m.plan.sb_off[d] + c.sb])


# ---------------------------------------------------------------------------
# models beyond the table kernels' staging: a def of more pair-list entries
# than the tag kernel's shared memory holds, and more defs than one pass of
# the flat kernel's scan carries
# ---------------------------------------------------------------------------


def _wide_pairs_model(S=300, L=MAX_LEN, seed=5):
    """A random S-state table over bytes 97..122 whose every transition is
    a substring transition: one def of 7511 (prev, next) pairs, beyond the
    4096 the tag kernel stages in shared memory (over 256 states, so always
    split; ``max_pairs`` lets it be)."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs, SubstrRegexDef

    rng = np.random.default_rng(seed)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line, trans = 3, set()
    for c in range(97, 123):
        for s in range(S):
            n = int(rng.integers(0, S))
            allstr.state_lookup[(c, s)] = (line, n)
            line += 1
            trans.add((s, n))
    sub = SubstrRegexDef(max_length=L, min_position=0, max_position=L,
                         valid_state_transitions=trans, start_states=list(range(0, S, 7)),
                         end_states=list(range(3, S, 5)))
    return T.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[sub])],
                                          max_chars_size=L)


def _nine_def_model(n_words=40, L=MAX_LEN):
    """Nine dictionary defs (``zoo.dictionary_config`` at seeds 1..9); with
    40 words each has over 160 pairs, so ``auto`` resolves to monolithic."""
    cfgs = [T.DecomposedRegexConfig.from_json(T.zoo.dictionary_config(n_words, seed=s,
                                                                      max_byte_size=L))
            for s in range(1, 10)]
    return T.CompiledRegexModel.from_decomposed(cfgs, max_chars_size=L)


@pytest.mark.parametrize("segmented", [False, True])
def test_tag_beyond_shared_memory_on_card(dev, monkeypatch, segmented):
    """A split model of 7511 pairs in one def: the tag kernel searches the
    pairs past its shared-memory stage in global memory; the matcher on
    the card equals the CPU run on every field, with the path's launches."""
    from halo2_regex_tpu_torch.ops import pallas_scan as ps

    model = _wide_pairs_model()
    if segmented:
        monkeypatch.setenv("H2R_SEGMENT", "16")
    kw = dict(max_pairs=8192, grid_mode="segmented" if segmented else "batch")
    m = T.PallasMatcher(model, device=dev, **kw)
    assert m.mode == "split" and m.pairs.shape[1] > kernels.TABLE_TAG_SMEM_PAIRS
    rng = np.random.default_rng(15)
    chars = rng.integers(97, 123, size=(4099, MAX_LEN)).astype(np.uint8)
    lengths = rng.integers(0, MAX_LEN + 1, size=4099).astype(np.int32)
    ch, ln = torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev)
    st = m.run_planes(ch, ln, plain=True)[0]
    want = [torch.full_like(st, -7) for _ in range(3)]
    got = [torch.full_like(st, -7) for _ in range(3)]
    ps.tag_plain(st, m._firsts(4099), ln, m.pairs, 0, MAX_LEN, *want)
    kernels.table_tag_cuda(st, m._firsts(4099), ln, m.pairs, 0, MAX_LEN, *got)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(want[0].any() and want[1].any() and want[2].any())
    kernels.reset_launch_counts()
    res = m(ch, ln)
    torch.cuda.synchronize()
    want_counts = {k.name: 0 for k in kernels.KERNELS}
    want_counts.update({k.name: v for k, v in kernels.table_path_launches(m, 4099).items()})
    assert {k.name: k.launches for k in kernels.KERNELS} == want_counts
    _assert_same(res, T.PallasMatcher(model, device="cpu", **kw)(chars, lengths))


@pytest.mark.parametrize("n_words,smem", [(40, False), (12, True), (12, False)])
def test_flat_nine_defs_on_card(dev, monkeypatch, n_words, smem):
    """A monolithic model of nine defs: the flat kernel scans them in two
    groups in one launch, equal to flat_plain and, through the matcher, to
    the CPU run on every field; with 40 words a def the table (234 KiB)
    is read from global memory, with 12 it fits shared memory (and is
    also sent to global memory)."""
    from halo2_regex_tpu_torch.ops import pallas_scan as ps

    model = _nine_def_model(n_words)
    m = T.PallasMatcher(model, device=dev, mode="monolithic")
    assert m.n_defs == 9 > kernels.FLAT_GROUP_DEFS
    fits = kernels.flat_smem_bytes(*m.flat_table.shape, kernels._smem_optin(dev)) > 0
    assert fits == (n_words == 12)
    if not smem:
        monkeypatch.setattr(kernels, "flat_smem_bytes", lambda *a: 0)
    chars, lengths = _flat_corpus("dict40", 4099, 16)
    ch, ln = torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev)
    B = ch.shape[0]

    def outs():
        return ([torch.full((9, MAX_LEN, B), -7, dtype=torch.int32, device=dev)
                 for _ in range(4)]
                + [torch.full((MAX_LEN, B), -7, dtype=torch.int32, device=dev)
                   for _ in range(2)])

    want, got = outs(), outs()
    args = (m.class_map, m.flat_table, m.first_states, ch, ln)
    ps.flat_plain(*args, *want)
    kernels.table_flat_cuda(*args, *got)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((want[4] * want[5]).any())
    kernels.reset_launch_counts()
    res = m(ch, ln)
    torch.cuda.synchronize()
    assert kernels.TABLE_FLAT.launches == 1
    _assert_same(res, T.PallasMatcher(model, device="cpu", mode="monolithic")(chars, lengths))


def test_best_matcher_runs_what_it_returns(dev):
    """The ladder's table rung on both models returns a matcher whose first
    call on the card runs and equals the CPU run (no limit is left to raise
    there)."""
    from halo2_regex_tpu_torch.ops import best_matcher

    for model, kw, (chars, lengths) in (
        (_wide_pairs_model(), dict(max_pairs=8192), (np.full((64, MAX_LEN), 97, np.uint8),
                                                      np.full(64, MAX_LEN, np.int32))),
        (_nine_def_model(), {}, _flat_corpus("dict40", 64, 17)),
    ):
        m, name = best_matcher(model, backend="pallas", device=dev, **kw)
        assert name == "pallas"
        res = m(chars, lengths)
        torch.cuda.synchronize()
        _assert_same(res, T.PallasMatcher(model, device="cpu", **kw)(chars, lengths))


# ---------------------------------------------------------------------------
# the redesigned scan (the cp.async ring) and chunked post at awkward
# shapes: NW = 384 words (one and a half of the post's 256-word blocks),
# L = 128, 1000 (pack_raw, L_pad 1024) and 1024, every unroll, chunk
# lengths that leave a partial last chunk, every chunked post plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [128, 1000, 1024])
def test_redesigned_scan_and_post_match_plain(dev, monkeypatch, L):
    from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

    model = _model("from", L)
    B = 3 * 4096  # NW = 384
    chars, lengths = _corpus(B, L, 26)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    plan = bp.make_plan(model, "witness")
    assert plan.qpack == (L != 1000)
    quads = bp.raw_quads(ch, plan.L_pad)
    bits, en = kernels.pack_raw_cuda(plan, quads, lw)
    logs = bp.scan_plain(plan, bits)
    for u in (1, 2, 3, 4, 8):
        pu = bp.make_plan(model, "witness", unroll=u)
        assert torch.equal(kernels.scan_cuda(pu, bits), logs), u
    tplan = bp.make_plan(model, "witness", tiled=True)
    tiled = torch.from_numpy(bp.tile_corpus(chars, tplan.L_pad)).to(dev)
    cases = [
        (plan, lambda p: kernels.post_cuda(p, logs, en), lambda p: bp.post_plain(p, logs, en)),
        (bp.make_plan(model, "witness", knobs=BitplaneKnobs(emit="kdecode")),
         lambda p: kernels.post_cuda(p, logs, en), lambda p: bp.post_plain(p, logs, en)),
        (tplan, lambda p: kernels.post_tiled_cuda(p, logs, en, tiled),
         lambda p: bp.post_plain(p, logs, en, tiled)),
        (bp.make_plan(model, "witness", knobs=BitplaneKnobs(emit="planes")),
         lambda p: kernels.post_planes_cuda(p, logs, en),
         lambda p: bp.post_planes_plain(p, logs, en)),
        (bp.make_plan(model, "full"), lambda p: kernels.post_planes_cuda(p, logs, en),
         lambda p: bp.post_planes_plain(p, logs, en)),
    ]
    for p, run_k, run_p in cases:
        want = run_p(p)
        for cl in (32, 7, 1):
            monkeypatch.setattr(kernels, "POST_CL", cl)
            got = run_k(p)
            torch.cuda.synchronize()
            if isinstance(want, tuple):
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (p.emit, p.tiled, cl)
            else:
                assert torch.equal(got, want), (p.columns, p.emit, cl)


def test_post_launches_three_kernels(dev):
    """A chunked post call launches the chunk maps, the carries and the
    replay, each counted on the post kernel, in every emission;
    ``path_launches`` says so."""
    model = _model("from", MAX_LEN)
    for columns, k, kw in (("witness", kernels.POST, {}), ("full", kernels.POST_PLANES, {}),
                           ("witness", kernels.POST_DIRECT, dict(emit="direct"))):
        m = T.BitplaneMatcher(model, columns=columns, device=dev, **kw)
        assert kernels.path_launches(m.plan)[k] == 3
        kernels.reset_launch_counts()
        m(*_corpus(4096, MAX_LEN, 27))
        torch.cuda.synchronize()
        assert k.launches == 3


@pytest.mark.parametrize("L", [36, 100, 1000])
def test_direct_post_chunks_match_plain(dev, monkeypatch, L):
    """B3's direct mode, chunked: every field's rows against
    post_direct_plain at L = 36 and 100 (L_pad = L, a partial last chunk)
    and 1000 (L_pad 1024), NW = 384 words, chunk lengths 32, 12 and 4; a
    chunk length that is not a multiple of 4 is refused."""
    model = _model("from", L)
    B = 3 * 4096
    chars, lengths = _corpus(B, L, 28)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    pd = bp.make_plan(model, "witness", knobs=_knobs(emit="direct"))
    assert pd.emit == "direct" and kernels.path_launches(pd)[kernels.POST_DIRECT] == 3
    bits, en = bp.pack_plain(pd, bp.raw_quads(ch, pd.L_pad), lw)
    logs = kernels.scan_cuda(pd, bits)
    want = bp.post_direct_plain(pd, logs, en)
    assert bool(want.any())
    for cl in (32, 12, 4):
        monkeypatch.setattr(kernels, "POST_CL", cl)
        kernels.reset_launch_counts()
        got = kernels.post_direct_cuda(pd, logs, en)
        torch.cuda.synchronize()
        assert kernels.POST_DIRECT.launches == 3
        assert torch.equal(got, want), cl
    monkeypatch.setattr(kernels, "POST_CL", 7)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.post_direct_cuda(pd, logs, en)


def _fsm_planes(n_defs, L, B, seed):
    """Seeded ids / start / endf [n_defs, L, B] int32 on the CPU, small ids
    so neighbours often agree, every seventh string empty (zero columns)."""
    rng = np.random.default_rng(seed)
    out = [torch.from_numpy(rng.integers(0, 3, size=(n_defs, L, B)).astype(np.int32)),
           torch.from_numpy((rng.random((n_defs, L, B)) < 0.3).astype(np.int32)),
           torch.from_numpy((rng.random((n_defs, L, B)) < 0.3).astype(np.int32))]
    for t in out:
        t[..., ::7] = 0
    return out


@pytest.mark.parametrize("n_defs,L", [(1, 70), (4, 70), (1, 4100)])
def test_one_pass_fsm_both_directions(dev, monkeypatch, n_defs, L):
    """The one-pass FSMs where ``table_fsm_form`` picks them (17,000
    strings: a ragged last warp), both directions in one launch, each
    direction alone, over the whole L and on a window with carries on both
    sides, the backward codes in shared memory and in a global scratch
    (which L = 4100 takes by itself, and a ``TABLE_FSM_SMEM_LS`` of 0
    forces), against ``fsm_plain``."""
    from halo2_regex_tpu_torch.ops import pallas_scan as ps

    B = 17000
    assert kernels.table_fsm_form(B, dev) == 0 and B % 32
    ids, sta, ef = (t.to(dev) for t in _fsm_planes(n_defs, L, B, L + n_defs))
    q0, LS = (5, 50) if L == 70 else (100, 3900)
    rng = np.random.default_rng(12)
    entry = [torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(dev) for _ in range(2)]
    cases = {"whole": (0, L, (None,) * 3, (None,) * 3),
             "window": (q0, LS, (entry[0], ids[:, q0 - 1], ef[:, q0 - 1]),
                        (entry[1], ids[:, q0 + LS], sta[:, q0 + LS]))}
    smem_ls = kernels.TABLE_FSM_SMEM_LS
    for name, (p0, n, fc, bc) in cases.items():
        want_f = torch.full((L, B), -7, dtype=torch.int32, device=dev)
        want_b = want_f.clone()
        ps.fsm_plain(False, ids, sta, ef, *fc, p0, n, want_f)
        ps.fsm_plain(True, ids, sta, ef, *bc, p0, n, want_b)
        for dirs in (1, 2, 3):
            for smem in ((True, False) if n <= smem_ls else (False,)):
                monkeypatch.setattr(kernels, "TABLE_FSM_SMEM_LS", smem_ls if smem else 0)
                f = torch.full_like(want_f, -7) if dirs & 1 else None
                b = torch.full_like(want_b, -7) if dirs & 2 else None
                kernels.reset_launch_counts()
                kernels.table_fsms_cuda(ids, sta, ef, p0, n, f, b, fwd_carry=fc, bwd_carry=bc,
                                        cl=0)
                torch.cuda.synchronize()
                assert kernels.TABLE_FSM.launches == 1
                for got, want in ((f, want_f), (b, want_b)):
                    if got is not None:
                        assert torch.equal(got, want), (name, dirs, smem)


def test_fsm_launch_counts_on_card(dev):
    """``table_path_launches`` counts the one-pass FSMs as one launch and
    the chunked ones as three, and a matcher call launches that many."""
    model = _table_model("from")
    m = T.PallasMatcher(model, device=dev)
    for n in (17000, 4099):
        chars, lengths = _table_corpus("from", n, 13)
        want = kernels.table_path_launches(m, n)
        assert want[kernels.TABLE_FSM] == (1 if n == 17000 else 3)
        kernels.reset_launch_counts()
        got = m(torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev))
        torch.cuda.synchronize()
        assert {k: k.launches for k in kernels.KERNELS if k.launches} == want
        _assert_same(got, T.PallasMatcher(model, device="cpu")(chars, lengths))


@pytest.mark.parametrize("L,odd", [(1024, False), (36, False), (128, False), (128, True)])
def test_qpack_modes_at_shapes(dev, L, odd):
    """K1 in all four modes (binary, one-hot, class stage off, en_pack off)
    at B=32768 x L=1024 (16-byte loads), L = 36 (4-byte loads, a partial
    tile), L = 128, and chars at an odd address (byte loads), against
    ``qpack_plain``; lengths include every tile edge; one launch a call."""
    B = 32768
    model = _model("from", L)
    chars, lengths = _corpus(B, L, 23)
    lengths[:64] = np.resize(np.array([0, 31, 32, 33, L], np.int32), 64)[:64].clip(max=L)
    ch = torch.from_numpy(chars).to(dev)
    if odd:
        buf = torch.zeros(chars.size + 1, dtype=torch.uint8, device=dev)
        ch = buf[1:].view(chars.shape)
        ch.copy_(torch.from_numpy(chars))
        assert ch.data_ptr() % 4
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    for kw in ({}, dict(class_stage="onehot"), dict(class_stage=False), dict(en_pack=False)):
        plan = bp.make_plan(model, "witness", knobs=_knobs(**kw))
        assert plan.qpack and kernels.path_launches(plan)[kernels.QPACK] == 1
        bits, en = bp.qpack_plain(plan, ch, lw)
        kernels.reset_launch_counts()
        kb, ke = kernels.qpack_cuda(plan, ch, lw)
        torch.cuda.synchronize()
        assert kernels.QPACK.launches == 1
        assert torch.equal(kb, bits), kw
        assert (ke is None) == (en is None) == ("en_pack" in kw)
        if en is not None:
            assert torch.equal(ke, en), kw


def test_qpack_on_two_devices(dev):
    """K1 with one plan on two cards of one process, each launch above the
    48 KiB default of shared memory: the limit is raised on each card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    L = 1024
    model = _model("from", L)
    plan = bp.make_plan(model, "witness", knobs=_knobs())
    chars, lengths = _corpus(bp.TILE, L, 29)
    for d in ("cuda:0", "cuda:1"):
        ch = torch.from_numpy(chars).to(d)
        lw = bp.len_table(torch.from_numpy(lengths).to(d))
        bits, en = bp.qpack_plain(plan, ch, lw)
        kb, ke = kernels.qpack_cuda(plan, ch, lw)
        torch.cuda.synchronize(d)
        assert kb.device == ch.device and torch.equal(kb, bits) and torch.equal(ke, en), d


# ---------------------------------------------------------------------------
# the quad-word pack (B5 pack_raw, B6 tpack: csrc/bitplane_pack_words.cuh)
# and B4 fb_only, at both batch sizes
# ---------------------------------------------------------------------------

PACK_MODES = [{}, dict(class_stage="onehot"), dict(class_stage=False), dict(en_pack=False)]


def _edge_corpus(n, L, seed):
    """``_corpus`` with the lengths 0, 31, 32, 33 and L among the first."""
    chars, lengths = _corpus(n, L, seed)
    lengths[:64] = np.resize(np.array([0, 31, 32, 33, L], np.int32), 64)
    return chars, lengths


@pytest.mark.parametrize("B", [4096, 32768])
@pytest.mark.parametrize("L,offset", [(1000, 0), (1024, 0), (36, 0), (100, 0), (100, 1)])
def test_pack_raw_modes_at_shapes(dev, B, L, offset):
    """B5 in all four modes (binary, one-hot, class stage off, en_pack off)
    at B=4096 (NWS = 1) and B=32768, at L = 1000 (L_pad 1024) and with
    qpack=False at L = 1024, 36 and 100 (partial tiles), and on quads one
    int32 past a 16-byte boundary (4-byte copies), against ``pack_plain``;
    one launch a call."""
    model = _model("from", L)
    chars, lengths = _edge_corpus(B, L, 31)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    for kw in PACK_MODES:
        plan = bp.make_plan(model, "witness", knobs=_knobs(qpack=False, **kw))
        assert not plan.qpack and kernels.path_launches(plan)[kernels.PACK_RAW] == 1
        quads = bp.raw_quads(ch, plan.L_pad)
        if offset:
            buf = torch.empty(quads.numel() + offset, dtype=torch.int32, device=dev)
            moved = buf[offset:].view(quads.shape)
            moved.copy_(quads)
            quads = moved
            assert quads.data_ptr() % 16
        bits, en = bp.pack_plain(plan, quads, lw)
        kernels.reset_launch_counts()
        kb, ke = kernels.pack_raw_cuda(plan, quads, lw)
        torch.cuda.synchronize()
        assert kernels.PACK_RAW.launches == 1
        assert torch.equal(kb, bits), kw
        assert (ke is None) == (en is None) == ("en_pack" in kw)
        if en is not None:
            assert torch.equal(ke, en), kw


@pytest.mark.parametrize("B", [4096, 32768])
@pytest.mark.parametrize("L", [1024, 1000, 36, 100])
def test_tpack_modes_at_shapes(dev, B, L):
    """B6 in its three class-stage modes on ``tile_corpus`` output at both
    batch sizes, against ``tpack_plain`` and ``pack_plain`` on the same
    strings' raw quad rows; one launch a call."""
    model = _model("from", L)
    chars, lengths = _edge_corpus(B, L, 33)
    ch = torch.from_numpy(chars).to(dev)
    lw = bp.len_table(torch.from_numpy(lengths).to(dev))
    for kw in PACK_MODES[:3]:
        plan = bp.make_plan(model, "witness", knobs=_knobs(**kw), tiled=True)
        assert kernels.path_launches(plan)[kernels.TPACK] == 1
        tiled = torch.from_numpy(bp.tile_corpus(chars, plan.L_pad)).to(dev)
        bits, en = bp.tpack_plain(plan, tiled, lw)
        kernels.reset_launch_counts()
        kb, ke = kernels.tpack_cuda(plan, tiled, lw)
        torch.cuda.synchronize()
        assert kernels.TPACK.launches == 1
        assert torch.equal(kb, bits) and torch.equal(ke, en), kw
        rb, re_ = bp.pack_plain(plan, bp.raw_quads(ch, plan.L_pad), lw)
        assert torch.equal(kb, rb) and torch.equal(ke, re_), kw


@pytest.mark.parametrize("B", [4096, 32768])
@pytest.mark.parametrize("name,L,first", [("from", 1024, None), ("from", 1000, None),
                                          ("two_def", 36, None), ("two_def", 100, 0b10101),
                                          ("two_def", 1024, None), ("from", 1024, 0b10101)])
def test_fb_only_at_shapes(dev, B, name, L, first):
    """B4 at both batch sizes (clusters of 8 blocks over L_pad = 1024, of
    1 at L = 36 and 100), on a 2-def model too, with random log planes
    and the enable plane of edge lengths, against ``fb_only_plain``; with
    ``first``, the plan's first states set to 0b10101 (the compiled
    models' are 0, so the empty-string term shows only there).  The
    output lands in memory the allocator has just freed full of ones, so
    every word must be written (no zero fill); one launch."""
    plan = bp.make_plan(_model(name, L), "match")
    if first is not None:
        plan = dataclasses.replace(plan, first_states=(first,) * plan.n_defs)
    _chars, lengths = _edge_corpus(B, L, 37)
    NWS = B // bp.TILE
    en = bp.enable_plane(bp.len_table(torch.from_numpy(lengths)), plan.L_pad).to(dev)
    rng = np.random.default_rng(L)
    logs = torch.from_numpy(rng.integers(-2**31, 2**31, size=(NWS, plan.sb_sum, plan.L_pad, 128))
                            .astype(np.int32)).to(dev)
    want = bp.fb_only_plain(plan, logs, en)
    junk = torch.full_like(want, -1)
    del junk
    kernels.reset_launch_counts()
    got = kernels.fb_only_cuda(plan, logs, en)
    torch.cuda.synchronize()
    assert kernels.FB_ONLY.launches == 1
    assert torch.equal(got, want)


def test_fb_only_runs_one_kernel(dev):
    """A call of fb_only runs its kernel and nothing else on the card (no
    zero fill of its output): the profiler's device events of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan = bp.make_plan(_model("from", 1024), "match")
    _chars, lengths = _edge_corpus(bp.TILE, 1024, 39)
    en = bp.enable_plane(bp.len_table(torch.from_numpy(lengths)), plan.L_pad).to(dev)
    logs = torch.zeros((1, plan.sb_sum, plan.L_pad, 128), dtype=torch.int32, device=dev)
    kernels.fb_only_cuda(plan, logs, en)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernels.fb_only_cuda(plan, logs, en)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "fb_kernel" in names[0], names


# ---------------------------------------------------------------------------
# the portable scan (BatchMatcher) and the device-expand corpus path
# ---------------------------------------------------------------------------


def _past_length(chars, lengths, seed):
    """Nonzero bytes past each length (the scan reads them, as JAX's)."""
    rng = np.random.default_rng(seed)
    chars = chars.copy()
    for i in range(chars.shape[0]):
        chars[i, lengths[i]:] = rng.integers(1, 256, size=chars.shape[1] - lengths[i])
    return chars


@pytest.mark.parametrize("name,L,B", [("regex3", MAX_LEN, 4099), ("two_def", MAX_LEN, 4099),
                                      ("from", MAX_LEN, 4099), ("large", MAX_LEN, 4099),
                                      ("large", 18432, 64)])
def test_batch_matcher_on_card_matches_plain(dev, name, L, B):
    """BatchMatcher on the card (the table scan kernel: serial at 4099
    strings, chunked at 64 strings of 18432 bytes) equals its plain
    pipeline on the card and the CPU run on every field and dtype, with
    nonzero bytes past each length; the table scan launches as
    ``scan_path_launches`` says (1 or 2) and no other kernel does."""
    if name == "large":
        model = _large_model(L=L)
        rng = np.random.default_rng(3)
        chars = rng.integers(97, 103, size=(B, L)).astype(np.uint8)
        chars[::5, 3] = 7
        lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
        lengths[0] = L
    else:
        model = _model(name)
        chars, lengths = _table_corpus(name, B, 9)
    chars = _past_length(chars, lengths, 4)
    m = T.BatchMatcher(model, device=dev)
    ch, ln = torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev)
    kernels.reset_launch_counts()
    got = m(ch, ln)
    torch.cuda.synchronize()
    want_counts = {k.name: 0 for k in kernels.KERNELS}
    want_counts.update({k.name: v for k, v in kernels.scan_path_launches(m, B).items()})
    assert {k.name: k.launches for k in kernels.KERNELS} == want_counts
    assert want_counts["table_scan"] == (2 if L > MAX_LEN else 1)
    _assert_same(got, m.run(ch, ln, plain=True).map(lambda t: t.cpu()))
    if L == MAX_LEN:
        _assert_same(got, T.BatchMatcher(model, device="cpu")(chars, lengths))


@pytest.mark.parametrize("B,L", [(37, 64), (4099, 1000)])
def test_tile_corpus_device_on_card(dev, B, L):
    chars, _lengths = _corpus(B, L, 12)
    got = bp.tile_corpus_device(torch.from_numpy(chars).to(dev), 1024)
    assert got.device.type == "cuda" and torch.equal(got.cpu(),
                                                     torch.from_numpy(T.tile_corpus(chars, 1024)))


def test_device_expand_scan_job_on_card(dev, tmp_path):
    """The device-expand ScanJob (raw chunk upload, rows gathered on the
    card) counts what the host-packed job counts, for the bitplane match
    matcher in both layouts and the portable scan."""
    model = _model("regex3", 32)
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"\n".join([b"from:a@b.cd\r", b"nope", b"x" * 40, b""] * 300) + b"\n")
    for m in (T.BitplaneMatcher(model, columns="match", device=dev),
              T.BitplaneMatcher(model, columns="match", input_layout="tiled", device=dev),
              T.BatchMatcher(model, device=dev)):
        outs = []
        for dx in (False, True):
            c = T.ScanJob(m, [str(corpus)], batch_size=256, keep_newline=True, chunk_bytes=4096,
                          device_expand=dx).run()
            outs.append({k: v for k, v in c.snapshot().items() if k != "wall_seconds"})
        assert outs[0] == outs[1] and (outs[0]["strings"], outs[0]["matched"]) == (1200, 300)


# ---------------------------------------------------------------------------
# The prover's host layer (fault C9) and the sharded matchers on the card
# ---------------------------------------------------------------------------


def _host_equal(got, want):
    """Two results (RegexResults or dicts) equal column by column on the
    host, dtypes included."""
    got = got if isinstance(got, dict) else vars(got)
    want = want if isinstance(want, dict) else vars(want)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].cpu() if isinstance(got[k], torch.Tensor) else torch.from_numpy(np.asarray(got[k]))
        w = w.cpu() if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))
        assert g.dtype == w.dtype and torch.equal(g, w), k


def test_card_results_reach_the_host_layer(dev, tmp_path):
    """C9: ``np.asarray`` of a CUDA tensor raises, so ``RegexResult.to_numpy``
    and the witness functions failed on a card result.  Now a card result and
    a card witness dict go through ``to_numpy``, ``check_witness_batch``,
    ``expand_witness``, ``save_witness`` and ``dump_prover_rows`` unchanged,
    with the CPU run's outputs."""
    from halo2_regex_tpu_torch.witness.handoff import dump_prover_rows

    model = _model("from")
    chars, lengths = T.pack_batch([b"from:alice@gmail.com\r\n", b"xx\r\nfrom:bob@x.yz\r\n",
                                   b"from:bob@x.yz", b""] * 256, MAX_LEN)
    full = T.BitplaneMatcher(model, compact=False, device=dev)(chars, lengths)
    with pytest.raises((TypeError, RuntimeError)):
        np.asarray(full.match_ok)  # the fault's cause
    cpu = T.BitplaneMatcher(model, compact=False, device="cpu")(chars, lengths)
    host = full.to_numpy()
    _host_equal(host, cpu.to_numpy())
    ok = T.check_witness_batch(model.regex_defs, full)
    assert np.array_equal(ok, T.check_witness_batch(model.regex_defs, cpu))
    assert np.array_equal(ok, host.match_ok) and ok.sum() == 512
    w = T.BitplaneMatcher(model, columns="witness", device=dev)(chars, lengths)
    wc = T.BitplaneMatcher(model, columns="witness", device="cpu")(chars, lengths)
    ex = T.expand_witness(model, w, torch.from_numpy(chars).to(dev))
    _host_equal(ex, T.expand_witness(model, wc, chars))
    T.save_witness(tmp_path / "w.npz", model.regex_defs, full)
    _host_equal(T.load_witness(tmp_path / "w.npz")[1], host)
    i = int(np.flatnonzero(ok)[0])
    assert (dump_prover_rows(model.regex_defs, full.map(lambda a: a[i]))
            == dump_prover_rows(model.regex_defs, cpu.map(lambda a: a[i])))


def test_cli_handoff_on_card(dev, tmp_path):
    """The ``handoff`` command's row comes from the card's matcher (the
    default ``--device cuda``) and dumps the text that ``--device cpu``
    dumps, with the same message and exit code."""
    import contextlib
    import io

    from halo2_regex_tpu_torch.cli import main

    path = tmp_path / "from.npz"
    _model("from").save(path)
    got = []
    for d in ("cuda", "cpu"):
        out = tmp_path / f"{d}.txt"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["handoff", "--model", str(path), "--output", str(out), "--device", d,
                       "from:alice@gmail.com\r\n"])
        got.append((rc, buf.getvalue().replace(f"{d}.txt", "_.txt"), out.read_text()))
    assert got[0] == got[1] and got[0][0] == 0 and "verification clean" in got[0][1]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_distributed_matcher_on_card(dev, backend):
    """Four data shards on one card equal the unsharded card matcher and the
    CPU mesh's run, stats included."""
    model = _model("from")
    chars, lengths = _corpus(4096, MAX_LEN, 22)
    mesh = T.make_mesh(data=4, devices=[dev] * 4)
    got, stats = T.DistributedMatcher(model, mesh, backend=backend)(chars, lengths)
    assert got.match_ok.device.type == "cuda"
    ref = (T.BatchMatcher if backend == "xla" else T.PallasMatcher)(model, device=dev)
    _host_equal(got, ref(chars, lengths))
    cpu_mesh = T.make_mesh(data=4, devices=[torch.device("cpu")] * 4)
    want, want_stats = T.DistributedMatcher(model, cpu_mesh, backend=backend)(chars, lengths)
    _host_equal(got, want)
    _host_equal(stats, want_stats)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_seq_sharded_on_card(dev, shape):
    model = _model("regex3", 256)
    chars, lengths = _corpus(2048, 256, 23)
    mesh = T.make_mesh(*shape, devices=[dev] * 4)
    sm = T.SeqShardedMatcher(model, mesh)
    _host_equal(sm.match(chars, lengths), T.BatchMatcher(model, device=dev)(chars, lengths))
    cpu = T.SeqShardedMatcher(model, T.make_mesh(*shape, devices=[torch.device("cpu")] * 4))
    _host_equal(sm(chars, lengths), cpu(chars, lengths))


@pytest.mark.parametrize("per_shard", ["xla", "pallas"])
def test_speculative_on_card(dev, per_shard):
    """Speculation on the card: the same columns and rounds as on the CPU
    mesh, on a resyncing model and on a permutation DFA (every guess
    wrong: one round a shard)."""
    from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs
    from halo2_regex_tpu_torch.parallel.seq_parallel import SpeculativeSeqMatcher

    rng = np.random.default_rng(24)
    S, Lp = 300, 4096
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line = 3
    for c in range(97, 107):
        for s, t in enumerate(rng.permutation(S)):
            allstr.state_lookup[(c, s)] = (line, int(t))
            line += 1
    perm = T.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[])],
                                          max_chars_size=Lp)
    cases = [(_model("regex3", 256), *_corpus(256, 256, 25)),
             (perm, rng.integers(97, 107, size=(8, Lp)).astype(np.uint8),
              np.full((8,), Lp, np.int32))]
    for model, chars, lengths in cases:
        got = SpeculativeSeqMatcher(model, T.make_mesh(1, 4, devices=[dev] * 4),
                                    per_shard=per_shard)(chars, lengths)
        want = SpeculativeSeqMatcher(model, T.make_mesh(1, 4, devices=[torch.device("cpu")] * 4),
                                     per_shard=per_shard)(chars, lengths)
        _host_equal(got, want)
        if model is perm:
            assert int(got["spec_rounds"][0]) == 4


def test_launch_on_card_over_nccl(dev, tmp_path):
    """``parallel.launch`` at world size 1 over nccl counts what ScanJob
    counts on the same file."""
    import json
    import os
    import socket
    import subprocess
    import sys

    model = _model("from")
    model.save(tmp_path / "m.npz")
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"\n".join([b"from:a@b.cd\r", b"nope", b"x" * 40] * 300) + b"\n")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "halo2_regex_tpu_torch.parallel.launch", "--model",
         str(tmp_path / "m.npz"), "--corpus", str(corpus), "--batch-per-host", "256",
         "--keep-newline", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
         "--process-id", "0"], env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    c = T.ScanJob(T.BatchMatcher(model, device=dev), [str(corpus)], batch_size=256,
                  keep_newline=True).run()
    assert (got["strings"], got["n_matched"], got["bytes_scanned"], got["n_dead"]) == (
        c.strings, c.matched, c.bytes_scanned, c.dead)
    assert got["n_matched"] == 300


def test_make_mesh_default_on_card(dev):
    m = T.make_mesh()
    assert list(m.devices.flat) == [torch.device("cuda", i)
                                    for i in range(torch.cuda.device_count())]
    # "cuda" names the current device, as the tensors moved there report it
    assert list(T.make_mesh(devices=["cuda"] * 2).devices.flat) == [
        torch.device("cuda", torch.cuda.current_device())] * 2


# ---------------------------------------------------------------------------
# the serial-scan probes of tools/ (probes/): kernel against plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slab", [1, 8])
@pytest.mark.parametrize("L,TB,hi", [(1024, 256, 256), (72, 40, 256), (64, 33, 2**31)])
def test_probe_loop_floor_matches_plain(dev, L, TB, hi, slab):
    """Ragged column counts; sums that wrap at hi = 2**31."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9

    rng = np.random.default_rng(L + TB)
    x = torch.from_numpy(rng.integers(0, hi, size=(L, TB), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    got = p9.loop_floor(x, slab)
    assert torch.equal(got, p9.loop_floor_plain(x, slab))
    if hi == 256:
        assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))


@pytest.mark.parametrize("L", [5, 67, 200])
def test_probe_loop_floor_ragged_rows(dev, L):
    """Slab 1 at L not a multiple of the ring's groups of eight rows (L = 5:
    fewer rows than one group)."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9

    x = torch.from_numpy(np.random.default_rng(L).integers(0, 256, size=(L, 70))
                         .astype(np.int32)).to(dev)
    assert torch.equal(p9.loop_floor(x, 1), torch.cumsum(x, 0, dtype=torch.int32))


def test_probe_measure_counts_one_launch(dev):
    """A measurement on the card reads the launches of one call around it
    (not a literal), holds the output against the plain version and
    refuses an entry point that launches nothing."""
    from halo2_regex_tpu_torch.ops import kernels
    from halo2_regex_tpu_torch.probes import harness
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9

    x = p9.inputs(64, 32, dev=dev)[0]
    timer = harness.Timer(dev)
    n0 = kernels.LOOP_FLOOR.launches
    rec, out = harness.measure(timer, "card", "A_loop_floor", kernels.LOOP_FLOOR,
                               lambda: p9.loop_floor(x, 1), 64, lambda: p9.loop_floor_plain(x, 1),
                               library=lambda: torch.cumsum(x, 0, dtype=torch.int32))
    assert rec["launches"] == 1 and rec["max_abs_err"] == 0 and rec["library_ms"] > 0
    # the counted call, the warm-ups, the timed calls
    assert kernels.LOOP_FLOOR.launches - n0 == 1 + harness.WARMUP + harness.ITERS
    assert torch.equal(out, torch.cumsum(x, 0, dtype=torch.int32))
    with pytest.raises(AssertionError, match="launched"):
        harness.measure(timer, "card", "A_loop_floor", kernels.LOOP_FLOOR,
                        lambda: p9.loop_floor_plain(x, 1), 64, lambda: p9.loop_floor_plain(x, 1))


@pytest.mark.parametrize("L,TB,lo,hi", [(1024, 256, 0, 256), (40, 33, -300, 600),
                                        (64, 96, 0, 256)])
def test_probe_slab_scan_matches_plain(dev, L, TB, lo, hi):
    """L = 40: a group of AHEAD slabs cut short; bytes outside [0, 256)."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9

    x, classes, tk = p9.inputs(L, TB, seed=L, dev=dev)
    x = torch.from_numpy(np.random.default_rng(TB).integers(lo, hi, size=(L, TB))
                         .astype(np.int32)).to(dev)
    got, want = p9.slab_scan(tk, classes, x), p9.slab_scan_plain(tk, classes, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _perm_table(K, S, seed, dev):
    """A [K, 4S] table whose column blocks are permutations: no two walks
    of the slab kernel's maps ever meet."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([np.concatenate([rng.permutation(S) for _ in range(4)])
                                      for _ in range(K)]).astype(np.int32)).to(dev)


# [L, TB] of the chunked forms' card tests, and the C that ``scan_chunk``
# gives each on a card of 132 SMs: every compiled C, L not a multiple of C
# at each, L < C at 64 and 512 (at 128 the rule never gives L < C), TB not
# a multiple of 32, L a multiple of 8 (for the serial forms beside them)
FLOOR_CASES = [(72, 40, 64), (40, 33, 64), (128, 32, 64), (104, 3190, 64), (4104, 300, 128),
               (65536, 64, 512), (200, 4300, 512)]
SLAB_CASES = [(72, 40, 64), (40, 33, 64), (104, 3190, 64), (1000, 1000, 128),
              (1024, 4096, 512), (65536, 64, 512), (200, 4300, 512)]


def test_probe_chunked_cases_cover_every_chunk(dev):
    """The cases below reach every C the library compiles, at the C each
    is listed with, on this card's SM count."""
    if kernels._sms(dev) != 132:
        pytest.skip(f"the cases are sized for 132 SMs, not {kernels._sms(dev)}")
    for cases in (FLOOR_CASES, SLAB_CASES):
        assert [kernels.scan_chunk(L, TB, dev) for L, TB, _c in cases] == [c for *_, c in cases]
        assert {c for *_, c in cases} == set(kernels.SCAN_CHUNKS)


@pytest.mark.parametrize("slab", [1, 8])
@pytest.mark.parametrize("L,TB,C", FLOOR_CASES)
def test_probe_loop_floor_chunks_match_plain(dev, L, TB, C, slab):
    """The chunked form at every C (by the rule, the C of its case): L not
    a multiple of C and L < C, TB not a multiple of 32, sums that wrap,
    more tiles than SMs and configs[3]'s [65536, 64]; the serial form
    beside it."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9

    for hi in (256, 2**31):
        x = torch.from_numpy(np.random.default_rng(L + TB).integers(0, hi, size=(L, TB),
                                                                    dtype=np.int64)
                             .astype(np.int32)).to(dev)
        want = p9.loop_floor_plain(x, slab)
        assert torch.equal(p9.loop_floor(x, slab), want)
        assert torch.equal(p9.loop_floor(x, slab, "serial"), want)


def test_probe_chunked_calls_need_no_zero_fill(dev):
    """Two calls in a row, and calls after a larger grid, equal the plain
    version: the look-back's status words of earlier calls carry earlier
    epochs, and the ticket is back at 0 after every launch."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    big = p9.inputs(65536, 64, seed=3, dev=dev)
    small = p9.inputs(1024, 256, seed=4, dev=dev)
    model = T.zoo.email_headers_model(max_chars_size=1024, headers=("from",))
    tab, classes, first = (v.to(dev) if isinstance(v, torch.Tensor) else v
                           for v in p18.slab_tables(model))
    x18 = p18.inputs(1024, 4096, dev=dev)
    want = {"fb": p9.loop_floor_plain(big[0]), "fs": p9.loop_floor_plain(small[0]),
            "sb": p9.slab_scan_plain(big[2], big[1], big[0]),
            "ss": p9.slab_scan_plain(small[2], small[1], small[0]),
            "a": p18.slab_anatomy_plain(tab, classes, x18, first, 2)}
    calls = {"fb": lambda: p9.loop_floor(big[0], 1), "fs": lambda: p9.loop_floor(small[0], 8),
             "sb": lambda: p9.slab_scan(big[2], big[1], big[0]),
             "ss": lambda: p9.slab_scan(small[2], small[1], small[0]),
             "a": lambda: p18.slab_anatomy(tab, classes, x18, first, 2)}
    for key in ("fs", "fs", "fb", "fs", "ss", "ss", "sb", "ss", "a", "fs", "a", "sb", "fb"):
        got = calls[key]()
        got = got if isinstance(got, tuple) else (got,)
        w = want[key] if isinstance(want[key], tuple) else (want[key],)
        assert all(torch.equal(g, v) for g, v in zip(got, w)), key


@pytest.mark.parametrize("S", [1, 24, 32])
@pytest.mark.parametrize("L,TB,C", SLAB_CASES)
def test_probe_slab_chunks_match_plain(dev, L, TB, C, S):
    """The chunked slab kernel at every C (by the rule, the C of its case)
    with S = 1, 24 and 32 states and N_OUT = 1, 2 and 4, bytes outside
    [0, 256), from states other than 0, on a random table (its walks meet)
    and a permutation table (they never do); the serial form beside it."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    rng = np.random.default_rng(L + S)
    K = 16
    first = (L + TB) % 7 % S
    classes = torch.from_numpy(rng.integers(0, K, size=256).astype(np.int32)).to(dev)
    x = torch.from_numpy(rng.integers(-300, 600, size=(L, TB)).astype(np.int32)).to(dev)
    tables = [torch.from_numpy(rng.integers(0, S, size=(K, 4 * S)).astype(np.int32)).to(dev),
              _perm_table(K, S, S, dev)]
    for tab in tables:
        want = p9.slab_plain(tab, classes, x, first, 4)
        assert all(torch.equal(g, w) for g, w in
                   zip(p18.slab_anatomy(tab, classes, x, first, 4), want))
        assert all(torch.equal(g, w) for g, w in
                   zip(p18.slab_anatomy(tab, classes, x, first, 4, "serial"), want))
        for n_out in (1, 2):
            got = p18.slab_anatomy(tab, classes, x, first, n_out)
            assert all(torch.equal(g, w) for g, w in zip(got, want[:n_out])), n_out
        if first == 0:
            assert all(torch.equal(g, w) for g, w in zip(p9.slab_scan(tab, classes, x), want))


def _stale_scratch(kernel, x, n_blk: int, epoch: int, seed: int) -> torch.Tensor:
    """A look-back scratch of ``kernel``'s layout for ``n_blk`` tiles whose
    every status word carries ``epoch`` (its inclusive flag set, values and
    states at random): what calls of that epoch could have left."""
    rng = np.random.default_rng(seed)
    tile = kernels.LOOKBACK_TILE_BYTES[kernel.name]
    buf = np.zeros(kernels.LOOKBACK_TICKET_BYTES + n_blk * tile, dtype=np.uint8)
    st = buf[kernels.LOOKBACK_TICKET_BYTES:].reshape(n_blk, tile)
    if kernel is kernels.LOOP_FLOOR:  # (epoch << 1 | inclusive) << 32 | value
        words = (np.uint64(epoch << 1 | 1) << np.uint64(32)) | rng.integers(
            0, 2**32, size=(n_blk, 32), dtype=np.uint64)
        st[:] = words.view(np.uint8).reshape(n_blk, tile)
    else:  # 32 maps of four words, epoch << 40 | eight 5-bit entries; 32 end words
        maps = (np.uint64(epoch) << np.uint64(40)) | rng.integers(
            0, 2**40, size=(n_blk, 128), dtype=np.uint64)
        ends = (np.uint32(epoch) << np.uint32(5)) | rng.integers(
            0, 32, size=(n_blk, 32), dtype=np.uint32)
        st[:, :1024] = maps.view(np.uint8).reshape(n_blk, 1024)
        st[:, 1024:] = ends.view(np.uint8).reshape(n_blk, 128)
    return torch.from_numpy(buf).to(x.device)


def test_probe_chunked_scratch_reads_no_stale_word(dev, monkeypatch):
    """Each chunked kernel has a scratch of its own, with tile t's status
    words at an address fixed by t whatever the grid, so a word an earlier
    call left is never read as one of this call.  First, the scratch holds
    words of the epoch just before, over a grid four times as large, with
    wrong values and states; then each kernel's large grid at epoch e is
    followed by each kernel's small grid at 8e + k, 16e + k or 128e + k
    (where a word of another layout or grid would carry the small call's
    epoch in the bits that tag it).  Every call equals the plain version.
    The epochs and the fill are set on whatever scratch the wrapper takes
    (``lookback_scratch``, watched), so the test does not depend on how
    the scratches are keyed."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    big, small = p9.inputs(65536, 64, seed=5, dev=dev), p9.inputs(1024, 256, seed=6, dev=dev)
    model = T.zoo.email_headers_model(max_chars_size=1024, headers=("from",))
    tab, classes, first = (v.to(dev) if isinstance(v, torch.Tensor) else v
                           for v in p18.slab_tables(model))
    x18, x18s = p18.inputs(1024, 4096, seed=7, dev=dev), p18.inputs(200, 300, seed=8, dev=dev)
    calls = {  # kernel: (large call, its plain outputs), (small call, its plain outputs)
        kernels.LOOP_FLOOR: [(big[0], lambda x: (p9.loop_floor(x, 1),),
                              lambda x: (p9.loop_floor_plain(x),)),
                             (small[0], lambda x: (p9.loop_floor(x, 8),),
                              lambda x: (p9.loop_floor_plain(x),))],
        kernels.SLAB_SCAN: [(v[0], lambda x, v=v: p9.slab_scan(v[2], v[1], x),
                             lambda x, v=v: p9.slab_scan_plain(v[2], v[1], x))
                            for v in (big, small)],
        kernels.SLAB_ANATOMY: [(x, lambda x: p18.slab_anatomy(tab, classes, x, first, 2),
                                lambda x: p18.slab_anatomy_plain(tab, classes, x, first, 2))
                               for x in (x18, x18s)]}
    want = {(k, i): plain(x) for k, cs in calls.items() for i, (x, _c, plain) in enumerate(cs)}
    order = {}  # for the next call: its epoch, and a scratch to put in place first
    take = kernels.lookback_scratch

    def watched(kernel, t, n_blk):
        ptr, _epoch = take(kernel, t, n_blk)
        ent = next(e for e in kernels._LOOKBACK.values() if e[0].data_ptr() == ptr)
        if "fill" in order:
            ent[0] = order.pop("fill")
        ent[1] = order.pop("epoch", ent[1])
        return ent[0].data_ptr(), ent[1]

    monkeypatch.setattr(kernels, "lookback_scratch", watched)

    def run(kernel, i, epoch=None, fill=None):
        x, call, _p = calls[kernel][i]
        order.update({} if epoch is None else {"epoch": epoch})
        order.update({} if fill is None else {"fill": fill})
        got = call(x)
        assert all(torch.equal(g, w) for g, w in zip(got, want[(kernel, i)])), \
            (kernel.name, i, epoch)

    for kernel in calls:
        x = calls[kernel][0][0]
        n_blk = 4 * -(-x.shape[1] // 32) * -(-x.shape[0] // 64)
        for i in (0, 1):  # epochs 1000 and 2000, each over words of the one before
            run(kernel, i, 1000 * (i + 1), _stale_scratch(kernel, x, n_blk, 1000 * (i + 1) - 1, i))
    for e in (3, 10):  # epochs 24-39, 48-63, 384-399; 80-95, 160-175, 1280-1295
        for k in range(16):
            for writer in calls:
                for mult in (8, 16, 128):
                    for reader in calls:
                        run(writer, 0, e)
                        run(reader, 1, mult * e + k)


def test_probe_chunked_forms_launch_once(dev):
    """The chunked forms launch one kernel a call, the serial forms one;
    a table past 32 states takes the serial form by the rule."""
    from halo2_regex_tpu_torch.probes import probe_tpu9 as p9

    x, classes, tk = p9.inputs(1024, 256, dev=dev)
    wide = torch.zeros((4, 4 * 40), dtype=torch.int32, device=dev)  # S = 40
    for call in (lambda: p9.loop_floor(x, 1), lambda: p9.loop_floor(x, 8, "serial"),
                 lambda: p9.slab_scan(tk, classes, x), lambda: p9.slab_scan(tk, classes, x, "serial"),
                 lambda: p9.slab_scan(wide, classes % 4, x)):
        before = {k.name: k.launches for k in kernels.PROBE_KERNELS}
        call()
        torch.cuda.synchronize()
        moved = {k.name: k.launches - before[k.name] for k in kernels.PROBE_KERNELS
                 if k.launches != before[k.name]}
        assert list(moved.values()) == [1], moved
    with pytest.raises(ValueError, match="S <= 32"):
        p9.slab_scan(wide, classes % 4, x, "chunked")
    assert all(torch.equal(g, w) for g, w in zip(p9.slab_scan(wide, classes % 4, x),
                                                 p9.slab_scan_plain(wide, classes % 4, x)))


@pytest.mark.parametrize("L,lc", [(256, 128), (256, 7), (10, 4)])
@pytest.mark.parametrize("n_ops", [96, 192, 384, 768])
def test_probe_bitop_scan_matches_plain(dev, n_ops, L, lc):
    """Both forms; L = 10: fewer steps than the serial kernel's ring and
    the table kernel's stage hold."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    cls, st0 = p20.inputs(L, 2, seed=n_ops, dev=dev)
    want = p20.bitop_scan_plain(cls, st0, n_ops, lc=lc)
    zeros = torch.zeros_like(st0)  # the probe's own start: all zero out
    for form in p20.FORMS:
        got = p20.bitop_scan(cls, st0, n_ops, lc=lc, form=form)
        assert torch.equal(got, want), form
        assert bool(got.any())
        assert not bool(p20.bitop_scan(cls, zeros, n_ops, lc=lc, form=form).any())


@pytest.mark.parametrize("L,lc,nws", [(1024, 128, 8), (1000, 33, 1), (17, 1, 3), (1, 5, 1),
                                      (48, 16, 2)])
def test_probe_bitop_table_form_edges(dev, L, lc, nws):
    """The table form at the probe's width and at lengths that leave a
    partial ring stage, one step a chunk, one step in all; classes over
    the whole int32 range (bit 31 set)."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    cls, st0 = p20.inputs(L, nws, seed=L + lc, dev=dev)
    cls = cls ^ torch.randint(-(2**31), 2**31 - 1, cls.shape, dtype=torch.int32,
                              generator=torch.Generator().manual_seed(L)).to(dev)
    for n_ops in (96, 768):
        assert torch.equal(p20.bitop_scan(cls, st0, n_ops, lc=lc),
                           p20.bitop_scan_plain(cls, st0, n_ops, lc=lc)), n_ops


def test_probe_bitop_table_built_once(dev):
    """T equals its torch twin packed; once built for an n_ops, a call
    launches the scan alone, one launch; a call for a new n_ops builds
    its T first (two launches)."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    for n_ops in p20.N_OPS:
        want = p20.table_words(p20.bitop_table_plain(n_ops)).to(dev)
        assert torch.equal(p20.bitop_table_cuda(n_ops, dev), want), n_ops
    p20._TABLES.clear()
    cls, st0 = p20.inputs(64, 1, seed=4, dev=dev)
    for n_ops, want in ((96, {"bitop_table": 1, "bitop_scan": 1}), (96, {"bitop_scan": 1}),
                        (192, {"bitop_table": 1, "bitop_scan": 1}), (96, {"bitop_scan": 1})):
        before = {k.name: k.launches for k in kernels.PROBE_KERNELS}
        p20.bitop_scan(cls, st0, n_ops)
        torch.cuda.synchronize()
        moved = {k.name: k.launches - before[k.name] for k in kernels.PROBE_KERNELS
                 if k.launches != before[k.name]}
        assert moved == want, (n_ops, moved)
    assert p20.bitop_table(96, dev) is p20.bitop_table(96, dev)


@pytest.mark.parametrize("threads", [32, 1024])
@pytest.mark.parametrize("n_steps", [0, 7, 4096])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_probe_chains_matches_plain(dev, C, n_steps, threads):
    """Both forms; the fixed form's steps counter against its twin's."""
    from halo2_regex_tpu_torch.probes import probe_tpu56 as p56

    x = p56.inputs(C, seed=C, dev=dev)
    want = p56.chains_plain(x, n_steps)
    assert torch.equal(p56.chains(x, n_steps, threads, "serial"), want)
    assert torch.equal(p56.chains(x, n_steps, threads), want)
    assert p56.chains_steps(dev) == p56.chains_fixed_plain(x, n_steps)[1]


@pytest.mark.parametrize("threads", [32, 1024])
@pytest.mark.parametrize("n_steps", [2, 8, 21, 4096])
def test_probe_chains_fixed_exit(dev, n_steps, threads):
    """The exit: a start already at a fixed point stops at the first check
    (4 steps), below a group every step runs; rows of words that are no
    whole number of warps (their last warp padded with zeros); each call's
    counter is its own (a later call with fewer steps reads fewer)."""
    from halo2_regex_tpu_torch.probes import probe_tpu56 as p56

    fixed = p56.chains_plain(p56.inputs(4, seed=0, dev=dev), 64)
    assert torch.equal(p56.chains(fixed, n_steps, threads), fixed)
    assert p56.chains_steps(dev) == min(n_steps, 4)
    gen = torch.Generator().manual_seed(n_steps)
    odd = torch.randint(-(2**31), 2**31 - 1, (2, 5, 9), dtype=torch.int32, generator=gen).to(dev)
    got = p56.chains(odd, n_steps, threads)
    assert torch.equal(got, p56.chains_plain(odd, n_steps))
    assert p56.chains_steps(dev) == p56.chains_fixed_plain(odd, n_steps)[1]
    for form in p56.FORMS:  # one launch a call in either form
        before = kernels.CHAINS.launches
        p56.chains(fixed, n_steps, threads, form)
        assert kernels.CHAINS.launches == before + 1


# ---------------------------------------------------------------------------
# the table-kernel probes of tools/ (probes/): kernel against plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["pow", "serial"])
@pytest.mark.parametrize("store", ["shared", "regs"])
@pytest.mark.parametrize("R,steps", [(8, 1), (256, 1), (256, 1024), (1, 1024), (3, 7), (5, 0),
                                     (256, 1025), (3, 127), (7, 2), (300, 5)])
def test_probe_lane_gather_matches_plain(dev, R, steps, store, form):
    """Both forms in both stores, one launch a call, at the probes' chains
    and ragged row counts; one step with g past the row (the pow form
    squares nothing there)."""
    from halo2_regex_tpu_torch.probes import probe_tpu as p1

    g, f = p1.gather_inputs(R, seed=R + steps, dev=dev)
    want = p1.lane_gather_plain(g, f, steps, store)
    before = kernels.LANE_GATHER.launches
    got = p1.lane_gather(g, f, steps, store, form)
    torch.cuda.synchronize()
    assert kernels.LANE_GATHER.launches == before + 1 and torch.equal(got, want)
    assert torch.equal(p1.lane_gather(g, f, steps, store), want)
    big = g * 1000 + 128
    assert torch.equal(p1.lane_gather(big, f, 1, store, form), torch.gather(big, 1, f.long()))


def test_probe_lane_gather_entry_raises(dev):
    """Wrong forms and shapes raise ValueError in the wrapper; the C entry
    returns cudaErrorInvalidValue (1) for a form past 4, no rows or negative
    steps."""
    from halo2_regex_tpu_torch.probes import probe_tpu as p1

    g, f = p1.gather_inputs(4, dev=dev)
    for call in (lambda: p1.lane_gather(g, f, 8, "shared", "doubling"),
                 lambda: p1.lane_gather(g, f[:, :64], 8, "regs", "pow"),
                 lambda: p1.lane_gather(g.long(), f.long(), 8, "shared", "pow"),
                 lambda: p1.lane_gather(g, f, -1, "shared", "pow"),
                 lambda: p1.lane_gather_cuda(g.cpu(), f.cpu(), 8, "shared", "pow")):
        with pytest.raises(ValueError):
            call()
    lib = kernels.build_probes()
    out = torch.empty_like(g)
    st = kernels._stream(g)
    for R, steps, form in ((4, 8, 5), (0, 8, 3), (4, -1, 4), (4, 8, -1)):
        assert lib.h2r_lane_gather(g.data_ptr(), f.data_ptr(), out.data_ptr(), R, steps, form,
                                   st) == 1


@pytest.mark.parametrize("RT,R", [(256, 8), (3, 70)])
def test_probe_row_gather_matches_plain(dev, RT, R):
    from halo2_regex_tpu_torch.probes import probe_tpu as p1

    t = torch.from_numpy(np.random.default_rng(R).integers(-2**31, 2**31, size=(RT, 128),
                                                            dtype=np.int64).astype(np.int32))
    c = torch.from_numpy(np.random.default_rng(RT).integers(0, RT, size=R).astype(np.int32))
    t, c = t.to(dev), c.to(dev)
    assert torch.equal(p1.row_gather(t, c), p1.row_gather_plain(t, c))


@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("TB,LB", [(256, 256), (37, 13), (100, 1024)])
@pytest.mark.parametrize("form,pick", [("lookup", "gather"), ("onehot_mma", "gather"),
                                       ("onehot_mma", "sum"), ("class_mma", "gather"),
                                       ("class_mma", "sum")])
def test_probe_dfa_step_matches_plain(dev, form, pick, TB, LB, time_major):
    """Ragged strings (37, 100: a warp's 16 or 32 cut short) and steps (13:
    a ring group of 8 cut short); class_mma with K = 16 and K = 5."""
    from halo2_regex_tpu_torch.probes import probe_tpu as p1
    from halo2_regex_tpu_torch.probes import probe_tpu2 as p2

    shape = (LB, TB) if time_major else (TB, LB)
    c = p1.bytes_(*shape, seed=TB + LB, dev=dev)
    classes = None
    T = p1.table(seed=TB).to(dev)
    if form == "class_mma":
        classes, T = p2.class_inputs(seed=LB, dev=dev)
        if TB == 37:
            classes, T = classes % 5, T[:5].contiguous()
    got = p1.dfa_step(T, c, form, time_major, pick, classes)
    assert torch.equal(got, p1.dfa_step_plain(T, c, form, time_major, pick, classes))


@pytest.mark.parametrize("TB,LB,time_major,offset", [
    (40000, 16, True, 0), (40000, 16, False, 0), (1027, 37, True, 0), (1027, 37, False, 0),
    (512, 64, True, 1), (512, 64, False, 1)])
def test_probe_dfa_lookup_geometry(dev, TB, LB, time_major, offset):
    """The lookup's edges: more tiles than SMs (40000 strings: a block
    walks two tiles), TB and LB not multiples of 4 (4-byte copies and
    stores), and chars at a 4-byte offset (16-byte copies refused)."""
    from halo2_regex_tpu_torch.probes import probe_tpu as p1

    shape = (LB, TB) if time_major else (TB, LB)
    flat = p1.bytes_(1, shape[0] * shape[1] + offset, seed=TB, dev=dev)[0]
    c = flat[offset:].view(shape)
    T = p1.table(seed=LB).to(dev)
    kernels.reset_launch_counts()
    got = p1.dfa_step(T, c, "lookup", time_major)
    torch.cuda.synchronize()
    assert kernels.DFA_STEP.launches == 1
    assert torch.equal(got, p1.dfa_step_plain(T, c, "lookup", time_major))


@pytest.mark.parametrize("L,B", [(1024, 4096), (64, 100)])
@pytest.mark.parametrize("n_out", [1, 2, 4])
def test_probe_slab_anatomy_matches_plain(dev, n_out, L, B):
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    model = T.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    tab, classes, first = p18.slab_tables(model)
    x = torch.from_numpy(_corpus(B, L, seed=B)[0].T.astype(np.int32).copy()).to(dev)
    x[:, ::7] = p18.inputs(L, B, seed=1, dev=dev)[:, ::7] * 5 - 300  # outside [0, 256) too
    got = p18.slab_anatomy(tab.to(dev), classes.to(dev), x, first, n_out)
    want = p18.slab_anatomy_plain(tab.to(dev), classes.to(dev), x, first, n_out)
    assert len(got) == n_out and all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(torch.unique(got[0])) > 4


def test_probe_units_match_plain(dev):
    """nop (the wrap), onehot_count (bytes outside [0, 256), ragged TB; no
    rows, one row, rows that fill no cluster step, 32768 columns)."""
    from halo2_regex_tpu_torch.probes import probe_tpu2 as p2

    x = torch.tensor([[2**31 - 1, -1, 0, 5]], dtype=torch.int32, device=dev)
    assert torch.equal(p2.nop(x), p2.nop_plain(x))
    shapes = [(1024, 512), (33, 130)] + [(LB, TB) for LB in (0, 1, 1000, 1023)
                                         for TB in (16, 500, 32768)]
    for shape in shapes:
        c = torch.from_numpy(np.random.default_rng(shape[1]).integers(-300, 600, size=shape)
                             .astype(np.int32)).to(dev)
        assert torch.equal(p2.onehot_count(c), p2.onehot_count_plain(c)), shape
    edges = torch.tensor([-2**31, -65520, -2049, -1, 0, 255, 256, 2048, 2049, 65504, 65520,
                          2**31 - 1], dtype=torch.int32, device=dev)
    c = edges.repeat(64, 3)  # the half2 compares on int32's edges
    assert torch.equal(p2.onehot_count(c), p2.onehot_count_plain(c))


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (4096, 4096, 4096), (100, 70, 50)])
def test_probe_int8_mma_matches_plain(dev, M, N, K):
    from halo2_regex_tpu_torch.probes import probe_tpu17 as p17

    a, b = p17.inputs(M, N, K, seed=M + K, dev=dev)
    got = p17.int8_mma(a, b)
    assert torch.equal(got, p17.int8_mma_plain(a, b))
    if M % 16 == 0 and N % 8 == 0 and K % 8 == 0:
        assert torch.equal(got, torch._int_mm(a, b))


@pytest.mark.parametrize("M,N,K", [(64, 256, 96), (300, 260, 129), (1, 3, 5), (257, 384, 4096)])
def test_probe_int8_mma_unaligned_and_ragged(dev, M, N, K):
    """a at an odd address (the staging pass copies it to [M, Kp]), K not a
    multiple of 16, N not a multiple of 4 (direct stores), one row, N past
    one 256-column tile; the whole int8 range, -128 included."""
    from halo2_regex_tpu_torch.probes import probe_tpu17 as p17

    a, b = p17.inputs(M, N, K, seed=M + N, dev=dev)
    a.view(-1)[:2] = -128
    odd = torch.empty(M * K + 1, dtype=torch.int8, device=dev)[1:].view(M, K)
    odd.copy_(a)
    assert odd.data_ptr() % 16
    want = p17.int8_mma_plain(a, b)
    assert torch.equal(p17.int8_mma(odd, b), want)
    assert torch.equal(p17.int8_mma(a, b), want)


def test_probe_table_entry_points_raise_on_bad_shapes(dev):
    from halo2_regex_tpu_torch.probes import probe_tpu as p1
    from halo2_regex_tpu_torch.probes import probe_tpu2 as p2
    from halo2_regex_tpu_torch.probes import probe_tpu17 as p17
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    g, f = p1.gather_inputs(4, dev=dev)
    Tt, c = p1.table().to(dev), p1.bytes_(8, 16, dev=dev)
    a, b = p17.inputs(8, 8, 8, dev=dev)
    tab, classes, first = p18.slab_tables(T.zoo.email_headers_model(max_chars_size=16,
                                                                    headers=("from",)))
    bad = [lambda: p1.lane_gather(g, f[:, :64]), lambda: p1.row_gather(Tt[:, :64], c[0]),
           lambda: p1.dfa_step(Tt[:, :64].contiguous(), c), lambda: p2.nop(c.long()),
           lambda: p2.onehot_count(c[0]),
           lambda: p17.int8_mma(a, b[:4]),
           lambda: p18.slab_anatomy(tab.to(dev), classes.to(dev),
                                    p18.inputs(12, 8, dev=dev), first, 1)]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# the emission and decode probes of tools/ (probes/): kernel against plain
# version, and field_decode against B14
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["copy", "transpose"])
@pytest.mark.parametrize("shape", [(8, 8, 1024, 128), (3, 64, 64), (2, 68, 132), (1, 4, 4)])
def test_probe_tile_move_matches_plain(dev, shape, form):
    """Whole tiles, ragged tiles (68 x 132: edges of 4 and 4 words) and a
    single chunk."""
    from halo2_regex_tpu_torch.probes import probe_tpu47 as p47

    x = p47.words(shape, seed=len(shape), dev=dev)
    assert torch.equal(p47.tile_move(x, form), p47.tile_move_plain(x, form))


@pytest.mark.parametrize("form", ["permute", "swap", "mma_pack", "mma_select"])
@pytest.mark.parametrize("shape", [(8, 8, 1024, 128), (1, 64, 1024, 128), (2, 3, 64, 128)])
def test_probe_l4_pack_matches_plain(dev, shape, form):
    from halo2_regex_tpu_torch.probes import probe_tpu48 as p48
    from halo2_regex_tpu_torch.probes import probe_tpu47 as p47

    w = p47.words(shape, seed=shape[1], dev=dev)
    got = p48.l4_pack(w, form)
    assert torch.equal(got, p48.l4_pack_plain(w, form))
    if shape[:2] == (8, 8):
        assert torch.equal(p48.direct_full(got), p48.status_quo(w))


@pytest.mark.parametrize("form", ["swap", "mma_pack", "mma_select"])
@pytest.mark.parametrize("kind,L", [("random", 256), ("random", 64), ("real", 1024)])
def test_probe_field_decode_matches_plain_and_b14(dev, form, kind, L):
    """Random words (every bit of every field) and the g4 of the from:
    witness front; B14's ``decode`` on the same g4 gives the same words."""
    from halo2_regex_tpu_torch.probes import probe_tpu64 as p64
    from halo2_regex_tpu_torch.probes import probe_tpu68 as p68

    m = T.BitplaneMatcher(p64.from_model(L), columns="witness")
    kplan = T.BitplaneMatcher(p64.from_model(L), columns="witness", emit="kdecode").plan
    fields = p64.fields_of(m.plan)
    if kind == "real":
        chars, lengths = p64.batch(8192, L, dev)
        g4, _fb = p68.front(m.plan, chars, lengths)
        ch_l4 = p64.chars_l4(chars)
    else:
        rng = np.random.default_rng(L)
        g4 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, 8 * m.plan.n_groups, L, 128),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        ch_l4 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(8192, L // 4), dtype=np.int64)
                                 .astype(np.int32)).to(dev)
    got = p64.field_decode(g4, ch_l4, fields, form)
    assert torch.equal(got, p64.field_decode_plain(g4, ch_l4, fields, form))
    assert torch.equal(got, bp.decode(kplan, g4, ch_l4))


@pytest.mark.parametrize("form", ["swap", "mma_pack", "mma_select"])
def test_probe_witness_pipeline_matches_matcher(dev, form):
    from halo2_regex_tpu_torch.probes import probe_tpu64 as p64
    from halo2_regex_tpu_torch.probes import probe_tpu68 as p68

    m = T.BitplaneMatcher(p64.from_model(1024), columns="witness")
    chars, lengths = p64.batch(8192, 1024, dev)
    p68.same_witness(form, p68.witness_pipeline(m, chars, lengths, form), m(chars, lengths))


def test_probe_emit_entry_points_raise(dev):
    """Bad shapes on the card, and CPU tensors handed to a ``*_cuda``."""
    from halo2_regex_tpu_torch.probes import probe_tpu47 as p47
    from halo2_regex_tpu_torch.probes import probe_tpu48 as p48
    from halo2_regex_tpu_torch.probes import probe_tpu64 as p64

    x = p47.words((2, 64, 64), dev=dev)
    w = p47.words((1, 2, 96, 128), dev=dev)  # L not a multiple of 64
    g4 = torch.zeros((1, 16, 96, 128), dtype=torch.int32, device=dev)
    ch = torch.zeros((4096, 24), dtype=torch.int32, device=dev)
    bad = [lambda: p47.tile_move(p47.words((2, 6, 64), dev=dev)),
           lambda: p47.tile_move(x.long()), lambda: p47.tile_move(x, "swap"),
           lambda: p48.l4_pack(w), lambda: p48.l4_pack(w[..., :64].contiguous()),
           lambda: p64.field_decode(g4, ch, ((0, 0, 6),), "swap"),
           lambda: p64.field_decode(g4[:, :, :64].contiguous(), ch[:, :16].contiguous(),
                                    ((0, 0, 6),), "permute"),
           lambda: p47.tile_move_cuda(x.cpu()), lambda: p48.l4_pack_cuda(w.cpu()),
           lambda: p64.field_decode_cuda(g4[:, :, :64].cpu(), ch[:, :16].cpu(),
                                         ((0, 0, 6),), "swap")]
    # contiguous views at an odd storage offset: the vector loads need
    # 16-byte (tile_move) and 8-byte (field_decode's chars) alignment
    flat = p47.words((1 + 4096 * 16,), dev=dev)
    bad += [lambda: p47.tile_move(flat[1:1 + 2 * 64 * 64].view(2, 64, 64)),
            lambda: p47.tile_move(flat[2:2 + 2 * 64 * 64].view(2, 64, 64), "copy"),
            lambda: p64.field_decode(g4[:, :, :64].contiguous(), flat[1:].view(4096, 16),
                                     ((0, 0, 6),), "mma_pack")]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# the launch, accumulate, carry, class-chain and configs[3] table-step probes
# of tools/ (probes/): kernel against plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ones", "ints", "normal"])
@pytest.mark.parametrize("shape", [(4, 2, 128, 128), (2, 3, 64, 192), (1, 5, 256, 64),
                                   (1, 8, 192, 96), (2, 1, 64, 32), (1, 2, 320, 64)])
def test_probe_mma_accum_matches_plain(dev, shape, kind):
    """Bit-exact on integer inputs (the probe's all-ones, [-8, 8]); within
    2e-5 x sum |a b| on N(0, 1) inputs (f32 sums in another order)."""
    from halo2_regex_tpu_torch.probes import probe_tpu21 as p21

    a, b = p21.inputs(shape, kind, seed=shape[1], dev=dev)
    got, want = p21.mma_accum(a, b), p21.mma_accum_plain(a, b)
    if kind == "normal":
        assert (got - want).abs().le(p21.tolerance(a, b)).all()
    else:
        assert torch.equal(got, want)
    if kind == "ones":  # K a sum, carried: K (l + 1)
        assert torch.equal(got[:, :, 0, 0].cpu(), torch.tensor(
            [[shape[3] * (l + 1) for l in range(shape[1])]] * shape[0], dtype=torch.float32))


@pytest.mark.parametrize("NI,NL,M,K,N", [(2, 3, 128, 64, 256), (1, 2, 256, 96, 64),
                                         (3, 2, 64, 128, 192)])
def test_probe_mma_accum_n_ne_m(dev, NI, NL, M, K, N):
    """N != M, b built directly (integers in [-8, 8]: exact), against the
    plain version (which the tile walk's twin equals on these inputs:
    tests/test_torch_probes_redesign.py)."""
    from halo2_regex_tpu_torch.probes import probe_tpu21 as p21

    rng = np.random.default_rng(M + N)
    a, b = (torch.from_numpy(rng.integers(-8, 9, size=s).astype(np.float32))
            .to(dev, torch.bfloat16) for s in ((NI, NL, M, K), (NI, NL, K, N)))
    got = p21.mma_accum(a, b)
    assert got.shape == (NI, NL, M, N) and torch.equal(got, p21.mma_accum_plain(a, b))


@pytest.mark.parametrize("form", ["reduce", "serial"])
@pytest.mark.parametrize("steps", [1, 8, 64])
@pytest.mark.parametrize("L,nws,lc,start", [(256, 1, 64, "zero"), (1024, 8, 128, "seeded"),
                                            (96, 3, 32, "seeded")])
def test_probe_bitop_carry_matches_plain(dev, L, nws, lc, start, steps, form):
    """One position a chunk (the probe as written), eight, and every
    position (steps = lc where lc = 64); a word count that is not a
    multiple of the block (nws = 3); the zero start stays zero; both forms,
    one launch a call, and a view of cls off 16-byte alignment (the reduce
    form's 4-byte path)."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    steps = min(steps, lc)
    cls, st0 = p20.carry_inputs(L, nws, seed=L, dev=dev)
    if start == "zero":
        st0 = torch.zeros_like(st0)
    want = p20.bitop_carry_plain(cls, st0, lc, steps)
    before = kernels.BITOP_CARRY.launches
    got = p20.bitop_carry(cls, st0, lc, steps, form)
    torch.cuda.synchronize()
    assert kernels.BITOP_CARRY.launches == before + 1 and torch.equal(got, want)
    assert bool(got.any()) == (start != "zero")
    odd = torch.empty(cls.numel() + 1, dtype=torch.int32, device=dev)[1:].view(cls.shape)
    odd.copy_(cls)
    assert p20.carry_vec(odd, st0) == 1
    assert torch.equal(p20.bitop_carry(odd, st0, lc, steps, form), want)


@pytest.mark.parametrize("form", ["reduce", "serial"])
@pytest.mark.parametrize("NB,L,nws,lc,steps", [(2, 8192, 8, 128, 128), (1, 96, 3, 32, 7),
                                               (3, 64, 1, 16, 16), (5, 40, 2, 8, 5),
                                               (1, 4096, 1, 1, 1)])
def test_probe_bitop_carry_forms_at_other_shapes(dev, NB, L, nws, lc, steps, form):
    """Both forms at 64 MiB and at other string-group counts (1, 3, 5:
    tiles and clusters that do not fill the card, one position a chunk over
    4096), from a seeded start and from all ones; the twin of the reduce
    form beside them."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    rng = np.random.default_rng(L + nws + steps)
    cls = torch.from_numpy(rng.integers(0, 2**31, size=(NB, L, 1, nws, 128)).astype(np.int32))
    cls = cls.to(dev)
    st0 = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(1, nws, 128),
                                        dtype=np.int64).astype(np.int32)).to(dev)
    for s0 in (st0, torch.full_like(st0, -1)):
        want = p20.bitop_carry_plain(cls, s0, lc, steps)
        assert torch.equal(p20.bitop_carry(cls, s0, lc, steps, form), want)
        assert torch.equal(p20.bitop_carry_reduce_plain(cls, s0, lc, steps), want)


@pytest.mark.parametrize("NW", [130, 33, 4, 1])
def test_probe_bitop_carry_entry_words_not_a_multiple_of_4(dev, NW):
    """The C entry at word counts the wrapper never makes (NW = NWS x 128):
    NW % 4 != 0 takes 4-byte loads, NW = 4 one 16-byte lane; every cluster
    size the reduce form takes, and the serial form (cluster 0)."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    NB, L, lc, steps = 2, 64, 16, 16
    rng = np.random.default_rng(NW)
    cls = torch.from_numpy(rng.integers(0, 2**31, size=(NB, L, NW)).astype(np.int32)).to(dev)
    st0 = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(NW,),
                                        dtype=np.int64).astype(np.int32)).to(dev)
    ors = torch.zeros((NB, NW), dtype=torch.int32, device=dev)
    for i in range(L):
        ors |= cls[:, i]
    want = st0[None] & ~ors
    lib = kernels.build_probes()
    for cluster in (0, 1, 3, 8, 16):
        out = torch.empty((NB, NW), dtype=torch.int32, device=dev)
        assert lib.h2r_bitop_carry(cls.data_ptr(), st0.data_ptr(), out.data_ptr(), NB, NW, L, lc,
                                   steps, cluster, kernels._stream(cls)) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), cluster


def test_probe_bitop_carry_entry_raises(dev):
    """Wrong forms and shapes raise ValueError in the wrapper; the C entry
    returns cudaErrorInvalidValue (1) for a cluster past 16 or past the
    positions read, a negative one, and bad shapes, in either form."""
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

    cls, st0 = p20.carry_inputs(128, 1, dev=dev)
    for call in (lambda: p20.bitop_carry(cls, st0, 32, 1, "tree"),
                 lambda: p20.bitop_carry(cls, st0, 48, 1, "reduce"),
                 lambda: p20.bitop_carry(cls, st0, 32, 33, "reduce"),
                 lambda: p20.bitop_carry(cls, st0[:, :, :64], 32, 1, "reduce"),
                 lambda: p20.bitop_carry(cls.long(), st0.long(), 32, 1, "reduce"),
                 lambda: p20.bitop_carry(cls[:, ::2], st0, 32, 1, "reduce"),
                 lambda: p20.bitop_carry_cuda(cls.cpu(), st0.cpu(), 32, 1, "reduce")):
        with pytest.raises(ValueError):
            call()
    lib = kernels.build_probes()
    out = torch.empty((2, 128), dtype=torch.int32, device=dev)
    args = dict(NB=2, NW=128, L=128, LC=32, steps=1, cluster=1)
    for bad in (dict(cluster=17), dict(cluster=5), dict(cluster=-1), dict(steps=33),
                dict(LC=48), dict(NB=0), dict(NW=0), dict(cluster=0, steps=0)):
        a = {**args, **bad}
        assert lib.h2r_bitop_carry(cls.data_ptr(), st0.data_ptr(), out.data_ptr(), a["NB"],
                                   a["NW"], a["L"], a["LC"], a["steps"], a["cluster"],
                                   kernels._stream(cls)) == 1, bad


@pytest.mark.parametrize("form", ["chain", "table"])
@pytest.mark.parametrize("shape,lo,hi", [((64, 128), 0, 256), ((37, 11), -300, 600),
                                         ((1024, 4096), -2**31, 2**31)])
def test_probe_class_chain_matches_plain(dev, shape, lo, hi, form):
    """The probe's terms, bytes, ints far outside [0, 256) (the table form
    clamps: the same class), and an element count with a tail of 3."""
    from halo2_regex_tpu_torch.probes import probe_tpu6 as p6

    terms = p6.inputs()["terms"]
    c = torch.from_numpy(np.random.default_rng(shape[0]).integers(lo, hi, size=shape,
                                                                   dtype=np.int64)
                         .astype(np.int32)).to(dev)
    got = p6.class_chain(c, terms, form)
    assert torch.equal(got, p6.class_chain_plain(c, terms, form))
    assert torch.equal(got, p6.chain_library(c, terms)())


@pytest.mark.parametrize("form", ["lookup", "onehot_mma"])
@pytest.mark.parametrize("K,S,hilo,cmod,smod", [
    (96, 1008, True, True, True), (200, 1008, True, False, False),
    (128, 1024, True, False, True), (96, 1008, False, False, False),
    (16, 24, False, False, False), (256, 1024, False, False, False),
    (100, 77, True, True, False)])
def test_probe_dfa_wide_matches_plain(dev, K, S, hilo, cmod, smod, form):
    """The probes' (K, S), hi/lo or not, modulos, the lookup's table in
    shared memory and (past 227 KiB: 200, 128 and 256 classes) in global
    memory, K and S that fill no tile; classes past K and a seeded entry
    with states past S (both give state 0); 70 strings (a partial warp), L
    = 300 (a partial ring group)."""
    from halo2_regex_tpu_torch.probes import probe_tpu28 as p28

    rng = np.random.default_rng(K + S)
    hi = 256 if hilo else S + 2
    tbl = p28.as_table(rng.integers(0, hi, size=(K, 2 * S if hilo else S)).astype(np.float32))
    chars = torch.from_numpy(rng.integers(-5, K + 9, size=(300, 70)).astype(np.int32))
    entry = torch.from_numpy(rng.integers(0, S + 3, size=70).astype(np.int32))
    want = p28.dfa_wide_plain(tbl, chars, hilo, cmod, smod, entry)
    tbl, chars, entry = tbl.to(dev), chars.to(dev), entry.to(dev)
    got = p28.dfa_wide_cuda(tbl, chars, hilo, cmod, smod, entry, form)
    assert torch.equal(got.cpu(), want)
    if form == "lookup":
        assert p28.table_in_smem(K, S, dev) == (K * S <= 96 * 1024)
    assert len(torch.unique(want)) > 8


@pytest.mark.parametrize("table", ["random", "permutation"])
def test_probe_dfa_wide_chunked_lookup_repairs_as_its_twin(dev, table):
    """The chunked lookup (S1, S2) in chunks of 16 after 8 positions of
    warm-up: the states of the plain version and as many positions
    repaired as its twin, on a hi/lo table with classes and states out of
    range and on a permutation table (every wrong guess repaired); 130
    strings (five warps, a partial one), L = 1000."""
    from halo2_regex_tpu_torch.probes import probe_tpu28 as p28

    rng = np.random.default_rng(21)
    if table == "random":
        tbl = p28.as_table(rng.integers(0, 256, size=(96, 2016)).astype(np.float32))
        chars = rng.integers(-5, 105, size=(1000, 130))
        flags = dict(hilo=True, cmod=False, smod=True)
    else:
        tbl = p28.as_table(np.stack([rng.permutation(300) for _ in range(20)]).astype(np.float32))
        chars = rng.integers(0, 20, size=(1000, 130))
        flags = {}
    chars = torch.from_numpy(chars.astype(np.int32))
    want, n_twin = p28.lookup_chunks_plain(tbl, chars, C=16, W=8, **flags)
    assert torch.equal(want, p28.dfa_wide_plain(tbl, chars, **flags))
    before = p28.lookup_repaired(dev)
    got = p28.dfa_wide_cuda(tbl.to(dev), chars.to(dev), cw=(16, 8), **flags)
    assert torch.equal(got.cpu(), want)
    assert p28.lookup_repaired(dev) - before == n_twin > 0


def test_probe_dfa_wide_count_and_chain(dev):
    """v1's count form; two launches chained at the first's last row equal
    one (w3)."""
    from halo2_regex_tpu_torch.probes import probe_tpu28 as p28
    from halo2_regex_tpu_torch.probes import probe_tpu30 as p30

    tbl, chars = p28.probe_inputs(512, 64, dev=dev)
    t1 = tbl[:, :p28.S].contiguous()
    assert torch.equal(p28.dfa_wide(t1, chars, cmod=True, form="count"),
                       p28.dfa_wide_plain(t1, chars, cmod=True, form="count"))
    tbl, chars, entry = p30.probe_inputs(512, 64, dev=dev)
    one = p28.dfa_wide(tbl, chars, entry=entry, **p30.FLAGS)
    for form in ("lookup", "onehot_mma"):
        assert torch.equal(p30.chained(tbl, chars, entry, form), one)


def test_probe_configs3_step_equals_b8(dev):
    """The widened step on configs[3]'s own table and a slice of its batch
    equals B8's table scan there."""
    from halo2_regex_tpu_torch.probes import probe_tpu28 as p28

    rng = np.random.default_rng(3)
    nt = torch.from_numpy(rng.integers(0, 1008, size=(96, 1008)).astype(np.int32)).to(dev)
    cmap = torch.from_numpy(rng.integers(0, 96, size=256).astype(np.int32)).to(dev)
    chars = torch.from_numpy(rng.integers(32, 127, size=(64, 2048)).astype(np.uint8)).to(dev)
    recs = p28.configs3_lines(dev, nt, cmap, chars, 0)
    assert [r["max_abs_err"] for r in recs] == [0, 0, 0]


def test_probe_slab_opts_in_past_48k(dev):
    """probe_tpu6's k3: slab_anatomy on a [256, 128] table (132 KiB of
    shared memory, past the 48 KiB default)."""
    from halo2_regex_tpu_torch.probes import probe_tpu6 as p6
    from halo2_regex_tpu_torch.probes import probe_tpu18 as p18

    t = p6.inputs(dev=dev)
    ident = torch.arange(256, dtype=torch.int32, device=dev)
    for got, want in zip(p18.slab_anatomy(t["P4"], ident, t["x3"], 0, 2),
                         p18.slab_anatomy_plain(t["P4"], ident, t["x3"], 0, 2)):
        assert torch.equal(got, want)


def test_probe_t2_entry_points_raise(dev):
    """Bad shapes, misaligned views, out-of-range options on the card, and
    CPU tensors handed to a ``*_cuda``."""
    from halo2_regex_tpu_torch.probes import probe_tpu6 as p6
    from halo2_regex_tpu_torch.probes import probe_tpu20 as p20
    from halo2_regex_tpu_torch.probes import probe_tpu21 as p21
    from halo2_regex_tpu_torch.probes import probe_tpu28 as p28
    from halo2_regex_tpu_torch.probes import probe_tpu47 as p47

    a, b = p21.inputs((1, 1, 128, 128), "ints", dev=dev)
    cls, st0 = p20.carry_inputs(128, 1, dev=dev)
    c = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    flat = torch.zeros(1 + 64 * 128, dtype=torch.int32, device=dev)
    tbl, chars = p28.probe_inputs(64, 16, dev=dev)
    terms = p6.inputs()["terms"]
    bad = [lambda: p21.mma_accum(a[..., :80].contiguous(),  # K not a multiple of 32
                                 b[:, :, :80].contiguous()),
           lambda: p21.mma_accum(a[:, :, :96].contiguous(), b),  # M not a multiple of 64
           lambda: p21.mma_accum(a.float(), b),
           lambda: p20.bitop_carry(cls, st0, 48), lambda: p20.bitop_carry(cls, st0, 64, 65),
           lambda: p6.class_chain(flat[1:].view(64, 128), terms),
           lambda: p6.class_chain(c, [(0, 1)], "table"),
           lambda: p6.class_chain(c, terms * 2),
           lambda: p28.dfa_wide(tbl.float(), chars),
           lambda: p28.dfa_wide(tbl[:, :7].contiguous(), chars, hilo=True),
           lambda: p28.dfa_wide(tbl, chars.t()),
           lambda: p28.dfa_wide(tbl, chars, entry=chars[0, :8].contiguous()),
           lambda: p47.tile_move(p47.words((2, 64, 64), dev=dev), "copy",
                                 out=torch.empty((2, 64, 32), dtype=torch.int32, device=dev)),
           lambda: p21.mma_accum_cuda(a.cpu(), b.cpu()),
           lambda: p20.bitop_carry_cuda(cls.cpu(), st0.cpu()),
           lambda: p6.class_chain_cuda(c.cpu(), terms),
           lambda: p28.dfa_wide_cuda(tbl.cpu(), chars.cpu())]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("L", [96, 136, 1024, 2048])
@pytest.mark.parametrize("B", [1024, 2048, 4096, 32768])
def test_probe_marker_match_matches_plain(dev, B, L):
    """marker_match serial and at each chunk length against the plain
    verdict (and re's) on the probes' corpus; one launch a call.  The
    chunked form's edges: one and two word groups (NW = 32, 64), clusters
    of 3, 6, 12 and 16 blocks, one block of 17 rounds (L = 136, chunk 8)
    and blocks of two rounds (L = 2048)."""
    from halo2_regex_tpu_torch.probes import probe_tpu57_lib as lib
    from halo2_regex_tpu_torch.probes.probe_tpu64 import probe_corpus

    chars, lengths = probe_corpus(B, max(L, 128))
    chars, lengths = chars[:, :L].copy(), lengths.clip(max=L)
    st = lib.marker_stack(torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev))
    want = lib.marker_match_reduced_plain(st)
    assert torch.equal(want, lib.expected_plane(lib.expected(chars, lengths), dev))
    for chunk in (L,) + tuple(c for c in lib.CHUNKS if L % c == 0):
        kernels.reset_launch_counts()
        got = lib.marker_match(st, chunk)
        torch.cuda.synchronize()
        assert kernels.MARKER_MATCH.launches == 1 and torch.equal(got, want), chunk
        if chunk != L:
            assert torch.equal(lib.marker_chunks_plain(st, chunk), want)


def test_probe_marker_entry_points_raise(dev):
    """A word count not a multiple of 32, a chunk that does not divide L or
    that the kernel is not built for, int64, a strided view, a stack off
    16-byte alignment for the chunked form (its TMA boxes; the serial form
    reads 4-byte words and takes it), a CPU stack to the kernel's
    wrapper."""
    from halo2_regex_tpu_torch.probes import probe_tpu57_lib as lib

    st = torch.zeros((10, 1024, 128), dtype=torch.int32, device=dev)
    wide = torch.zeros((10, 1024, 256), dtype=torch.int32, device=dev)
    odd = torch.zeros((10 * 1024 * 128 + 1,), dtype=torch.int32, device=dev)[1:].view(st.shape)
    assert torch.equal(lib.marker_match(odd, 1024), lib.marker_match(st, 1024))
    bad = [lambda: lib.marker_match(odd, 16),
           lambda: lib.marker_match(st[:, :, :48].contiguous(), 16),
           lambda: lib.marker_match(st, 24), lambda: lib.marker_match(st, 128),
           lambda: lib.marker_match(st.long(), 16),
           lambda: lib.marker_match(wide[:, :, ::2], 16),
           lambda: lib.marker_match_cuda(st.cpu(), 16)]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_profiling_device_specs_are_the_cards(dev):
    """The card's row by its name: its SM count and L2 are what torch reads
    from the card; the default device is the same row."""
    from halo2_regex_tpu_torch.utils import profiling

    spec = profiling.device_specs(dev)
    props = torch.cuda.get_device_properties(dev)
    assert spec["kind"] == torch.cuda.get_device_name(dev)
    assert spec["sm_count"] == props.multi_processor_count
    if hasattr(props, "L2_cache_size"):
        assert spec["l2_bytes"] == props.L2_cache_size
    assert profiling.device_specs() == spec
    assert profiling.scan_roofline_bytes_per_sec(dev) == spec["hbm_gbps"] / 6
    assert profiling.FLUSH_BYTES > spec["l2_bytes"]


def test_profiling_timers_on_the_card(dev):
    """``time_ms`` under the reading flush, the write flush and none, in
    both windows; ``benchmark`` waits for the work it times (a 20M-cycle
    spin queued on the current stream before the result)."""
    from halo2_regex_tpu_torch.utils import profiling

    x = torch.ones(1 << 24, dtype=torch.int32, device=dev)
    calls = []

    def fn():
        calls.append(1)
        return x + 1

    for kw in (dict(), dict(flush=profiling.L2Flush(dev, write=True)), dict(flush=False),
               dict(flush=profiling.L2Flush(dev))):
        for device_only in (True, False):
            t = profiling.time_ms(fn, device_only, warmup=1, iters=4, **kw)
            assert t["runs"] == 4 == len(t["all"]) and min(t["all"]) > 0, kw
    assert len(calls) == 8 * 5

    def spin():
        torch.cuda._sleep(20_000_000)
        return x + 1

    assert profiling.benchmark(spin, iters=3) > 0.009  # >= 20M cycles at 1.98 GHz
    assert profiling.benchmark_chained(lambda k: lambda: [spin() for _ in range(k)][-1],
                                       (), ks=(1, 3)) > 0.009


@pytest.mark.parametrize("name", ["extract_email_torch", "corpus_scan_torch",
                                  "prover_handoff_torch"])
def test_example_on_the_card(dev, name, capsys):
    """Each example's ``main`` with its defaults: the card (the table scan
    for extract_email, the bitplane kernels for corpus_scan); prover_handoff
    runs on the host."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels.reset_launch_counts()
    assert mod.main() == 0
    launched = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    out = capsys.readouterr().out
    if name == "extract_email_torch":
        assert "table_scan" in launched and "vitalik" in out
    elif name == "corpus_scan_torch":
        assert out.startswith("backend: bitplane") and "scan" in launched and "OK" in out
    else:
        assert not launched and "hand-off verified" in out
