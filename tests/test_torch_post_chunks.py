"""The chunked decomposition of the post kernel's mask FSMs, on the CPU.

``csrc/bitplane_post.cu`` cuts L into chunks of CL positions: each chunk
composes its forward and backward FSM maps (launch A), the carry-ins are
composed across chunks (B), and each chunk replays its positions from them
(C).  ``bitplane.post_chunks_plain`` runs those phases in torch ops; here
it is held equal to ``post_plain`` (the log-scan FSMs) on every output
word, and the direct mode's twin ``post_direct_chunks_plain`` to
``post_direct_plain`` on every row, for chunk lengths 1, 3, 32 and L, for
L not a multiple of CL or of 32, with strings that end on a chunk edge,
empty strings and matches that span chunk edges.  Integer outputs:
tolerance 0.  No JAX.
"""

import numpy as np
import pytest
import torch

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

from fixtures import CONFIGS

PIECES = [b"from:", b"@", b".", b"<", b">", b"\r\n", b"ab", b"x.y", b"gmail.com",
          b"email was meant for @", b" Also for ", b"abc", b"xy"]
B = 4096  # one NWS row


def _model(name, L):
    if name == "from":
        return T.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    cfgs = ["regex1", "regex2"] if name == "two_def" else [name]
    return T.CompiledRegexModel.from_decomposed(
        [T.DecomposedRegexConfig.from_json(CONFIGS[c]) for c in cfgs], max_chars_size=L)


def _corpus(L, seed):
    """Matches placed across the edges of 32- and 3-position chunks,
    strings that end on a chunk edge or are empty, then seeded strings of
    the models' pieces and random bytes."""
    rng = np.random.default_rng(seed)
    rows = []
    for start in (0, 1, 20, 29, 31, 32, 33):
        for line in (b"\r\nfrom:alice@gmail.com\r\n", b"from:Al <bob@x.yz>\r\n",
                     b"email was meant for @yajk. Also for swq."):
            rows.append(b"x" * start + line)
    rows += [b"", b"\r\n", b"from:"] + [b"ab c" * 8 + b"\r\nfrom:z@gmail.com\r\n"[:n]
                                        for n in (1, 6, 12, 18, 23)]
    while len(rows) < B:
        if len(rows) % 7 == 3:
            rows.append(rng.integers(0, 256, size=int(rng.integers(0, L + 1)))
                        .astype(np.uint8).tobytes())
        else:
            rows.append(b"".join(PIECES[j] for j in
                                 rng.integers(0, len(PIECES), size=int(rng.integers(0, 9)))))
    chars = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, s in enumerate(rows):
        s = s[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    # strings that end exactly on a chunk edge (32, 3)
    lengths[-8:] = [min(v, L) for v in (32, 64, 3, 6, 30, 33, 0, L)]
    return chars, lengths


@pytest.fixture(scope="module", params=[("regex3", 64), ("two_def", 64), ("from", 64),
                                        ("from", 40), ("regex3", 200)],
                ids=lambda p: f"{p[0]}-L{p[1]}")
def case(request):
    """One model's plan, log planes and enable plane from the plain pack
    and scan (computed once per case), the post_plain reference, and the
    direct emission's plan (the same scan) with its post_direct_plain
    reference."""
    name, L = request.param
    model = _model(name, L)
    plan = bp.make_plan(model, "witness")
    chars, lengths = _corpus(L, 3)
    lw = bp.len_table(torch.from_numpy(lengths))
    bits, en = bp.pack_plain(plan, bp.raw_quads(torch.from_numpy(chars), plan.L_pad), lw)
    logs = bp.scan_plain(plan, bits)
    want = bp.post_plain(plan, logs, en)
    pd = bp.make_plan(model, "witness", knobs=BitplaneKnobs(emit="direct"))
    assert pd.emit == "direct"
    return plan, logs, en, want, (pd, bp.post_direct_plain(pd, logs, en))


@pytest.mark.parametrize("CL", [1, 3, 32, "L"])
def test_chunked_post_equals_post_plain(case, CL):
    plan, logs, en, (g4, fb), _direct = case
    cl = plan.L_pad if CL == "L" else CL
    got_g4, got_fb = bp.post_chunks_plain(plan, logs, en, cl)
    assert got_g4.dtype == g4.dtype and torch.equal(got_g4, g4)
    assert got_fb.dtype == fb.dtype and torch.equal(got_fb, fb)


@pytest.mark.parametrize("CL", [1, 3, 32, "L"])
def test_chunked_direct_equals_post_direct_plain(case, CL):
    """The direct emission from the chunked FSMs: every field's rows."""
    plan, logs, en, _want, (pd, rows) = case
    cl = plan.L_pad if CL == "L" else CL
    got = bp.post_direct_chunks_plain(pd, logs, en, cl)
    assert got.dtype == rows.dtype and got.shape == rows.shape
    assert torch.equal(got, rows)


def test_chunk_edges_are_exercised(case):
    """The corpus puts masked substrings across the edges of 32-position
    chunks (and so of 1- and 3-position ones) and boundaries of strings on
    them: the FSM carries cross chunks in this test, not only within."""
    plan, logs, en, _want, _direct = case
    t = bp._tags_and_masks(plan, logs, en)
    if plan.L_pad > 32:
        across = t.mask[:, 31] & t.mask[:, 32]
        assert bool(across.any())
    assert bool(t.mask.any())
    bnd = en & ~bp._shift_up(en)
    assert bool(bnd[:, 31].any()) and bool((~en[:, 0]).any())


def test_tiled_chunked_post_equals_post_plain():
    """The tiled mode's masked characters, from the same chunked FSMs."""
    L = 64
    model = _model("from", L)
    plan = bp.make_plan(model, "witness", tiled=True)
    chars, lengths = _corpus(L, 4)
    tiled = torch.from_numpy(bp.tile_corpus(chars, plan.L_pad))
    lw = bp.len_table(torch.from_numpy(lengths))
    bits, en = bp.tpack_plain(plan, tiled, lw)
    logs = bp.scan_plain(plan, bits)
    want = bp.post_plain(plan, logs, en, tiled)
    for cl in (5, 32):
        got = bp.post_chunks_plain(plan, logs, en, cl, tiled)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
