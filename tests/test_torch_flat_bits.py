"""The flat kernel's bit-packed backward column, on the CPU.

``csrc/table_flat.cu`` (B12, the monolithic table matcher) no longer parks
a full int32 a position for its backward FSM: its forward pass packs three
bits a position -- changed_p (position p's id sum against p + 1's, 0 past
L), start_any_p and endf_any_p -- 32 positions a word into a [3, ceil(L /
32), B] scratch, and the backward pass reads only those words.  Beyond 8
defs it scans groups of 8, parks the running id sum and flags, and the
last group completes them.  ``pallas_scan.flat_bits_plain`` runs those
passes in torch ops; here it is held equal to ``flat_plain`` on all six
planes, and its words to the flags of ``flat_plain``'s planes, for 1, 2,
4 and 9 defs (the email-header models), at L = 70 (not a multiple of 32)
and L = 64, with empty strings and id sums that change exactly at a
32-position edge.  Integer outputs: tolerance 0.  No JAX.
"""

import numpy as np
import pytest
import torch

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import pallas_scan as ps

B = 300
HEADERS = {1: ("from",), 2: ("from", "to"), 4: ("from", "to", "subject", "from"),
           9: ("from", "to", "subject") * 3}
LINES = [b"from:Al <bob@x.yz>", b"to:alice@gmail.com", b"subject:hello you", b"from:z@q.io"]


def _corpus(L, seed):
    """Header lines placed after ``\r\n`` at every offset up to 40 and so
    that a line ends at position 31, 63 or L - 1 (an address or subject,
    the public parts, starts or ends exactly at a 32-position edge: the
    id sum changes there), two lines in one string, lengths that cut a
    line, empty strings, and random letters."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, line in enumerate(LINES):
        line = b"\r\n" + line + b"\r\n"
        rows += [b"x" * k + line for k in range(41)]
        for end in (31, 63, L - 1):  # the public part's last byte is here
            rows.append(b"y" * (end + 3 - len(line)) + line)
        rows.append(line + LINES[(i + 1) % len(LINES)] + b"\r\n")
    chars = rng.integers(97, 123, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    for i, s in enumerate(rows[:B - 8]):
        s = s[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s) if i % 9 else max(0, len(s) - 3)  # some lengths cut the line
    lengths[-8:] = [0, 0, 1, 31, 32, 33, L - 1, L]
    return chars, lengths


@pytest.fixture(scope="module", params=[(1, 70), (2, 70), (4, 70), (9, 70), (1, 64), (9, 64)],
                ids=lambda p: f"defs{p[0]}-L{p[1]}")
def case(request):
    """The monolithic matcher's tables for an email-header model of n defs
    (repeated headers for 4 and 9), a corpus, and the six planes of
    ``flat_plain`` (computed once per case)."""
    n_defs, L = request.param
    model = T.zoo.email_headers_model(max_chars_size=L, headers=HEADERS[n_defs])
    m = T.PallasMatcher(model, mode="monolithic", device="cpu")
    assert m.n_defs == n_defs
    chars, lengths = _corpus(L, 5)
    args = (m.class_map, m.flat_table, m.first_states, torch.from_numpy(chars),
            torch.from_numpy(lengths))

    def planes():
        return ([torch.full((n_defs, L, B), -7, dtype=torch.int32) for _ in range(4)]
                + [torch.full((L, B), -7, dtype=torch.int32) for _ in range(2)])

    want = planes()
    ps.flat_plain(*args, *want)
    return args, planes, want


def test_flat_bits_equals_flat_plain(case):
    args, planes, want = case
    got = planes()
    bits = ps.flat_bits_plain(*args, *got)
    assert bits.dtype == torch.int32 and bits.shape == (3, -(-want[4].shape[0] // 32), B)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool((want[4] & want[5]).any())  # the mask lights up


def test_flat_bits_hold_the_backward_flags(case):
    """Bit p - 32 j of word j is changed_p, start_any_p, endf_any_p of
    ``flat_plain``'s planes; the bits past L are 0."""
    args, planes, want = case
    _states, ids, start, endf = want[:4]
    L = ids.shape[1]
    isum = ids.long().sum(0)
    changed = isum != torch.cat([isum[1:], torch.zeros_like(isum[:1])])
    flags = torch.stack([changed, start.any(0), endf.any(0)]).long()  # [3, L, B]
    NJ = -(-L // 32)
    flags = torch.cat([flags, flags.new_zeros((3, 32 * NJ - L, B))], 1).reshape(3, NJ, 32, B)
    words = (flags << torch.arange(32).reshape(1, 1, 32, 1)).sum(2)
    bits = ps.flat_bits_plain(*args, *planes())
    assert torch.equal(bits, ps._as_int32(words))


def test_id_sums_change_at_word_edges(case):
    """The corpus makes the changed bit cross a word edge: set at position
    31 (the sum at 31 against 32) and at 63; strings of length 0 are
    there."""
    args, _planes, want = case
    isum = want[1].long().sum(0)
    L = isum.shape[0]
    for p in (31, 63) if L > 64 else (31,):
        assert bool((isum[p] != isum[p + 1]).any())
    assert bool((isum[L - 1] != 0).any())  # the last position's bit: no sum past L
    assert bool((args[4] == 0).any())
