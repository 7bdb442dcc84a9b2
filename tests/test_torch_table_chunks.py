"""The chunked forms of the table scan and mask FSM kernels, on the CPU.

``csrc/table_scan.cu`` spreads the split matcher's scan over chunks of L:
each chunk guesses its entry state from a warm-up of W positions (S1), and
a repair pass walks the chunks in order and re-scans those whose guess was
wrong until they meet the stored states (S2).  ``csrc/table_fsm.cu``
composes the FSMs' set/reset/hold maps per chunk (A), chains them (B) and
replays each chunk (C).  ``pallas_scan.scan_chunks_plain`` and
``fsm_chunks_plain`` run those phases in torch ops; here they are held
equal to ``scan_plain`` and ``fsm_plain`` bit for bit (integer outputs:
tolerance 0) on BASELINE configs[3]'s 1000-state table at L=8192, the
from: model, the 3-def email model, a DFA that never resyncs (every class
a permutation, so every guess fails and S2 repairs every chunk), W = 0 and
W >= L, L not a multiple of C, B = 37, random entry states, and FSM
windows with carries on both sides.  The card's one pass over [0, L) is
held equal to the plain pipeline's windows.  No JAX.
"""

import numpy as np
import pytest
import torch

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs
from halo2_regex_tpu_torch.ops import pallas_scan as ps


def _random_table(S, alphabet, L, seed, permutation=False):
    """One def over ``alphabet``: a random S-state table as configs[3] draws
    it, or one whose every byte permutes the states (it never resyncs)."""
    rng = np.random.default_rng(seed)
    allstr = AllstrRegexDef(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line = 3
    for c in alphabet:
        perm = rng.permutation(S) if permutation else None
        for s in range(S):
            nxt = int(perm[s]) if permutation else int(rng.integers(0, S))
            allstr.state_lookup[(c, s)] = (line, nxt)
            line += 1
    return T.CompiledRegexModel.from_defs([RegexDefs(allstr=allstr, substrs=[])],
                                          max_chars_size=L)


def _email_corpus(B, L, seed):
    """Header lines of the email models and random filler."""
    rng = np.random.default_rng(seed)
    chars = rng.integers(97, 123, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    heads = [b"from:", b"to:", b"subject:"]
    for i in range(B):
        at = int(rng.integers(0, max(1, L - 64)))
        s = (b"\r\n" + heads[i % 3] + b"al <bo@x.yz>\r\n" * int(rng.integers(1, 3)))[: L - at]
        chars[i, at : at + len(s)] = bytearray(s)
    return chars, lengths


@pytest.fixture(scope="module")
def cases():
    """name -> (matcher on the CPU, chars [B, L] uint8 tensor, lengths)."""
    out = {}
    rng = np.random.default_rng(0)
    big = _random_table(1000, range(32, 127), 8192, 0)  # configs[3]'s table, L cut
    out["config3"] = (T.PallasMatcher(big, max_pairs=4096, device="cpu"),
                      rng.integers(32, 127, size=(4, 8192)).astype(np.uint8),
                      np.full(4, 8192, np.int32))
    perm = _random_table(300, range(97, 103), 3000, 1, permutation=True)
    out["permutation"] = (T.PallasMatcher(perm, device="cpu"),
                          rng.integers(97, 103, size=(37, 3000)).astype(np.uint8),
                          rng.integers(0, 3001, size=37).astype(np.int32))
    for name, headers in (("from", ("from",)), ("email3", ("from", "to", "subject"))):
        model = T.zoo.email_headers_model(max_chars_size=512, headers=headers)
        out[name] = (T.PallasMatcher(model, device="cpu"), *_email_corpus(37, 512, 2))
    return {k: (m, torch.from_numpy(c), torch.from_numpy(ln)) for k, (m, c, ln) in out.items()}


def _plain_states(m, chars, init, p0, LS):
    want = torch.full((m.n_defs, m.L, chars.shape[0]), -7, dtype=torch.int32)
    ps.scan_plain(m.class_map, m.next_table, chars, init, p0, LS, want)
    return want


# (case, C, W, window): W = 0, W >= L, L or the window not a multiple of C
SCAN_CASES = [
    ("config3", 1024, 2048, None), ("config3", 512, 0, None), ("config3", 1000, 300, None),
    ("config3", 2048, 8192, None), ("permutation", 256, 128, None),
    ("permutation", 700, 0, (100, 2900)), ("from", 64, 32, None), ("from", 48, 0, (16, 400)),
    ("email3", 100, 50, None), ("email3", 64, 512, None),
]


@pytest.mark.parametrize("name,C,W,window", SCAN_CASES,
                         ids=[f"{c[0]}-C{c[1]}-W{c[2]}" + ("-win" if c[3] else "")
                              for c in SCAN_CASES])
def test_scan_chunks_equal_scan_plain(cases, name, C, W, window):
    """Every state of the window equals the serial scan's, for every DFA,
    and the repair count is the number of positions whose speculative
    state was wrong."""
    m, chars, _ = cases[name]
    B = chars.shape[0]
    p0, LS = window or (0, m.L)
    init = (m._firsts(B) if p0 == 0
            else _plain_states(m, chars, m._firsts(B), 0, m.L)[:, p0 - 1].contiguous())
    want = _plain_states(m, chars, init, p0, LS)
    got = torch.full_like(want, -7)
    repaired = ps.scan_chunks_plain(m.class_map, m.next_table, chars, init, p0, LS, C, W, got)
    assert torch.equal(got, want)
    # the speculative states, walked independently in numpy: chunk c from
    # init at max(p0, cs - W)
    nxt, cmap, ch = (t.numpy() for t in (m.next_table, m.class_map, chars))
    wrong = 0
    for d in range(m.n_defs):
        for b in range(B):
            for cs in range(p0, p0 + LS, C):
                s = int(init[d, b])
                for p in range(max(p0, cs - W), min(cs + C, p0 + LS)):
                    s = int(nxt[d, cmap[d, ch[b, p]], s])
                    wrong += p >= cs and s != int(want[d, p, b])
    assert repaired == wrong
    if name == "permutation":  # never resyncs: every speculative position is wrong
        exact = min(LS, -(-W // C) * C) if W else C
        assert wrong > 0.99 * m.n_defs * B * (LS - exact)
    if W >= LS:
        assert repaired == 0


def test_scan_chunks_random_entry_states(cases):
    """Random entry states (the scan_states_tm case) on configs[3]'s table."""
    m, chars, _ = cases["config3"]
    init = torch.from_numpy(np.random.default_rng(4).integers(0, 1000, size=(1, 4))
                            .astype(np.int32))
    want = _plain_states(m, chars, init, 0, m.L)
    got = torch.full_like(want, -7)
    ps.scan_chunks_plain(m.class_map, m.next_table, chars, init, 0, m.L, 1024, 1024, got)
    assert torch.equal(got, want)


def _planes(m, chars, lengths):
    return m.run_planes(chars, lengths, plain=True)


@pytest.mark.parametrize("CL", [1, 7, 64])
@pytest.mark.parametrize("name", ["from", "email3"])
def test_fsm_chunks_equal_fsm_plain(cases, name, CL):
    """Both FSMs over the whole L (null carries) and on a middle window
    with carries on both sides, whose length is not a multiple of CL."""
    m, chars, lengths = cases[name]
    _st, ids, sta, ef, fwd, bwd = _planes(m, chars, lengths)
    assert bool(fwd.any()) and bool(bwd.any()) and bool(ids.any())
    none = (None, None, None)
    got_f, got_b = torch.full_like(fwd, -7), torch.full_like(bwd, -7)
    ps.fsm_chunks_plain(ids, sta, ef, none, none, 0, m.L, CL, got_f, got_b)
    assert torch.equal(got_f, fwd) and torch.equal(got_b, bwd)
    # a window whose edges cut a mask on each side
    q0 = int(fwd[:-1].any(1).nonzero()[0]) + 1
    q1 = int(bwd[1:].any(1).nonzero()[-1]) + 1
    assert q1 - q0 > 2 * 64 and (q1 - q0) % 64
    fc = (fwd[q0 - 1], ids[:, q0 - 1], ef[:, q0 - 1])
    bc = (bwd[q1], ids[:, q1], sta[:, q1])
    assert bool(fc[0].any()) and bool(bc[0].any())
    want_f, want_b = torch.full_like(fwd, -7), torch.full_like(bwd, -7)
    ps.fsm_plain(False, ids, sta, ef, *fc, q0, q1 - q0, want_f)
    ps.fsm_plain(True, ids, sta, ef, *bc, q0, q1 - q0, want_b)
    got_f, got_b = torch.full_like(fwd, -7), torch.full_like(bwd, -7)
    ps.fsm_chunks_plain(ids, sta, ef, fc, bc, q0, q1 - q0, CL, got_f, got_b)
    assert torch.equal(got_f, want_f) and torch.equal(got_b, want_b)
    assert torch.equal(got_f[q0:q1], fwd[q0:q1]) and torch.equal(got_b[q0:q1], bwd[q0:q1])
    # one direction alone
    only_b = torch.full_like(bwd, -7)
    ps.fsm_chunks_plain(ids, sta, ef, fc, bc, q0, q1 - q0, CL, None, only_b)
    assert torch.equal(only_b, want_b)


@pytest.mark.parametrize("name", ["from", "email3", "permutation"])
def test_one_pass_equals_windows(cases, monkeypatch, name):
    """The card's pipeline -- one pass over [0, L): the chunked scan, the
    tag, both chunked FSMs -- equals ``run_planes``' windows of the plain
    stages (H2R_SEGMENT=64, carries across every window), and the result
    of the matcher."""
    m, chars, lengths = cases[name]
    monkeypatch.setenv("H2R_SEGMENT", "64")
    seg = T.PallasMatcher(m.model, grid_mode="segmented", device="cpu")
    assert seg.n_seg == m.L // seg.window > 1
    want = seg.run_planes(chars, lengths, plain=True)
    B, L = chars.shape
    firsts = m._firsts(B)
    st = torch.empty((m.n_defs, L, B), dtype=torch.int32)
    ps.scan_chunks_plain(m.class_map, m.next_table, chars, firsts, 0, L, 96, 48, st)
    tags = [torch.empty_like(st) for _ in range(3)]
    ps.tag_plain(st, firsts, lengths, m.pairs, 0, L, *tags)
    fwd, bwd = torch.empty((L, B), dtype=torch.int32), torch.empty((L, B), dtype=torch.int32)
    none = (None, None, None)
    ps.fsm_chunks_plain(*tags, none, none, 0, L, 64, fwd, bwd)
    got = (st, *tags, fwd, bwd)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    res = seg.finish(chars, lengths, *got)
    ref = m(chars, lengths)
    for k in T.RegexResult.field_names():
        assert torch.equal(getattr(res, k), getattr(ref, k)), k
