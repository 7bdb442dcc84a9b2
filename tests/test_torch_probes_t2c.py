"""The marker-stream probes' plain versions against the probes themselves.

Both TPU kernels (``make_marker_kernel`` of tools/probe_tpu57.py :190 and
tools/probe_tpu61.py :228) are read from their scripts with ``ast``
(``_load`` of tests/test_torch_probes.py: ``L``, ``LANE``, ``os`` and the
JAX lib tools/probe_tpu57_lib.py as ``mk`` / ``mklib`` are free names) and
run by ``pallas_call`` in interpret mode at B = 4096 (NT = 1) and 8192
(NT = 2) on the probes' corpus (L = 128) and on a corpus of near misses
(L = 64, 96 and 128).  The port's ``marker_match_reduced_plain``,
``marker_match_plain`` and the chunked twin ``marker_chunks_plain`` at
chunk 8, 16, 32 and L must each equal the body bit for bit, and Python
``re``.  The near misses hold a from: line at every offset (so one crosses
every chunk boundary), empty strings and strings of length L that match.

Also: the port's copy of the lib against the JAX lib, the kernel's class
header against ``Program.to_c``, ``pack_bytes`` / ``pack_bool`` against
JAX's, a ``hypothesis`` property (the plain verdict equals ``re`` on
strings of near-miss tokens), the chunk summaries' composition, two
mutations of the plain version that the body tells apart, and the chunked
kernel's split of L (``geometry``, its constants read from
csrc/probe_marker.cu): a cluster's blocks each folding their chunks in
order, then the first folding the blocks' in order, at NW = 32 and 64
words, every chunk length and L with 1 to 16 blocks and 1 or 2 rounds a
block, against the plain verdict and ``re``; two blocks folded out of
order is told apart.  The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import functools
import importlib.util
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from halo2_regex_tpu.ops import bitplane as jbp
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops import kernels
from halo2_regex_tpu_torch.probes import probe_tpu57_lib as lib
from halo2_regex_tpu_torch.probes.probe_tpu64 import probe_corpus

from test_torch_probes import TOOLS, _load

LANE = 128
SCRIPTS = [("probe_tpu57.py", "mk"), ("probe_tpu61.py", "mklib")]
# the near misses' pieces: a prefix, the head, the name, the '@', the domain, the tail
PRE = [b"", b"\r\n", b"x y\r\n", b"\n", b"\r", b"\r\n\r\n"]
HEAD = [b"from:", b"From:", b"fro:", b"from", b"rom:", b"from:from:"]
NAME = [b"bob", b"a.b-C9", b"b ob", b"x@y", b"", b"-"]
AT = [b"@", b"", b"@@"]
DOM = [b"x.yz", b"gmail.com", b"a b", b"", b".-", b"q@r"]
TAIL = [b"\r\n", b"\r", b"\n", b"\r\n\r\n", b"", b"\r\nx", b"\r\nfrom:a@b\r\n"]
TOKENS = sorted(set(PRE + HEAD + NAME + AT + DOM + TAIL + [b"ab", b" ", b":", b"\x00"]))


@functools.lru_cache(maxsize=1)
def _jax_lib():
    spec = importlib.util.spec_from_file_location("probe_tpu57_lib",
                                                  os.path.join(TOOLS, "probe_tpu57_lib.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pack(strings, L):
    """Strings (each cut to L) -> chars [B, L] uint8 and lengths [B] int32."""
    chars = np.zeros((len(strings), L), np.uint8)
    lengths = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        s = s[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@functools.lru_cache(maxsize=None)
def near_miss(B: int, L: int, seed: int = 0):
    """B strings of at most L bytes: a from: line at every offset o (its
    \\r\\n at o, so its bytes cross every chunk boundary), an empty string,
    two of length L that match (the line flush at the end, or a whole
    string that is one line), then filler and near-miss pieces."""
    rng = np.random.default_rng(seed)
    line = b"\r\nfrom:bob@x.yz\r\n"
    rows = [b"a" * o + line for o in range(L - len(line) + 1)]
    rows += [b"", b"c" * (L - len(line)) + line, b"from:" + b"n" * (L - 11) + b"@d.e\r\n"]
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz :@.-\r\n", np.uint8)
    while len(rows) < B:
        filler = rng.choice(letters, size=int(rng.integers(0, L // 2))).tobytes()
        parts = [PRE, HEAD, NAME, AT, DOM, TAIL]
        s = filler + b"".join(p[int(rng.integers(0, len(p)))] for p in parts)
        rows.append(s if rng.random() < 0.8 else s + s)
    return _pack(rows[:B], L)


def _corpus(kind: str, B: int, L: int):
    return probe_corpus(B, L) if kind == "probe" else near_miss(B, L)


@functools.lru_cache(maxsize=None)
def _stack(kind: str, B: int, L: int) -> np.ndarray:
    chars, lengths = _corpus(kind, B, L)
    return lib.marker_stack(torch.from_numpy(chars.copy()),
                            torch.from_numpy(lengths.copy())).numpy()


def _want_re(kind: str, B: int, L: int) -> np.ndarray:
    chars, lengths = _corpus(kind, B, L)
    return lib.expected_plane(lib.expected(chars, lengths), torch.device("cpu")).numpy()


@functools.lru_cache(maxsize=None)
def _body(script: str, B: int, L: int, kind: str) -> np.ndarray:
    """The TPU kernel of ``script``, interpret mode, on the stack."""
    name = dict(SCRIPTS)[script]
    make = _load(script, "make_marker_kernel", L=L, LANE=LANE, os=os, **{name: _jax_lib()})
    NWS = B // 32 // LANE
    st_ = _stack(kind, B, L)
    return np.asarray(make(NWS, NT=2)(jnp.asarray(st_.reshape(10, L, B // 32)))).reshape(-1)


CASES = [(B, L, kind) for B in (4096, 8192)
         for L, kind in ((128, "probe"), (64, "near"), (96, "near"), (128, "near"))]


@pytest.mark.parametrize("B,L,kind", CASES)
@pytest.mark.parametrize("script", [s for s, _ in SCRIPTS])
def test_marker_body_equals_plain(script, B, L, kind):
    want = _body(script, B, L, kind)
    stack = torch.from_numpy(_stack(kind, B, L))
    assert np.array_equal(want, _want_re(kind, B, L))  # the body is re's verdict
    got = {"reduced": lib.marker_match_reduced_plain(stack), "plain": lib.marker_match_plain(stack)}
    got.update({f"chunk{c}": lib.marker_chunks_plain(stack, c) for c in (8, 16, 32, L)})
    for name, g in got.items():
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), want), name
    # the entry point on the CPU: the reduced form serial, the twin chunked
    assert torch.equal(lib.marker_match(stack, L), got["reduced"])
    assert torch.equal(lib.marker_match(stack, 16), got["chunk16"])
    if kind == "near":  # some strings match, some do not, bit 31 among them
        assert want.any() and (~want).any() and (want < 0).any()


def test_near_miss_corpus_covers_the_edges():
    chars, lengths = near_miss(4096, 96)
    ok = lib.expected(chars, lengths)
    assert ok[: 96 - 17 + 1].all()  # the from: line at every offset
    assert lengths[96 - 16] == 0 and not ok[96 - 16]  # the empty string
    assert (lengths[96 - 15: 96 - 13] == 96).all() and ok[96 - 15: 96 - 13].all()
    assert 0 < ok[96:].sum() < 4096 - 96


def test_lib_copy_equals_jax():
    jl = _jax_lib()
    assert lib.CLASS_PROG.instrs == jl.CLASS_PROG.instrs
    assert lib.CLASS_PROG.inputs == jl.CLASS_PROG.inputs
    assert lib.CLASS_PROG.outputs == jl.CLASS_PROG.outputs
    assert (lib.PY_PATTERN, lib.NAME_BYTES, lib.DOM_BYTES) == (jl.PY_PATTERN, jl.NAME_BYTES,
                                                               jl.DOM_BYTES)
    assert (lib.CLASS_PROG.n_ops, lib.CLASS_PROG.n_regs) == (76, 84)


def test_class_header_is_to_c():
    path = os.path.join(os.path.dirname(lib.__file__), os.pardir, "csrc", lib.CLASS_HEADER)
    with open(path) as f:
        assert f.read() == lib.class_header()


@pytest.mark.parametrize("L,L_pad", [(36, 36), (36, 64), (64, 64), (100, 128)])
@pytest.mark.parametrize("B", [32, 4096])
def test_packers_equal_jax(B, L, L_pad):
    rng = np.random.default_rng(B + L + L_pad)
    chars = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    want = [np.asarray(p) for p in jbp.pack_bytes(jnp.asarray(chars), L_pad)]
    got = bp.pack_bytes(torch.from_numpy(chars), L_pad)
    assert len(got) == 8 and all(g.dtype == torch.int32 for g in got)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    col = rng.integers(0, 2, size=(B, L)).astype(bool)
    assert np.array_equal(bp.pack_bool(torch.from_numpy(col), L_pad).numpy(),
                          np.asarray(jbp.pack_bool(jnp.asarray(col), L_pad)))
    # one verdict a string, as the probes pack re's
    e = col[:, :1].astype(np.uint8)
    assert np.array_equal(bp.pack_bool(torch.from_numpy(e), 1).numpy(),
                          np.asarray(jbp.pack_bool(jnp.asarray(e), 1)))


def test_packers_refuse_odd_batches():
    with pytest.raises(ValueError):
        bp.pack_bytes(torch.zeros((48, 8), dtype=torch.uint8), 8)
    with pytest.raises(ValueError):
        bp.pack_bool(torch.zeros((32, 9), dtype=torch.bool), 8)


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.lists(st.sampled_from(TOKENS), max_size=10), min_size=1, max_size=64))
def test_plain_verdict_is_re(token_rows):
    strings = [b"".join(r) for r in token_rows]
    strings += [b""] * (1024 - len(strings))  # NW = 32 words: the stack's least width
    chars, lengths = _pack(strings, 48)
    stack = lib.marker_stack(torch.from_numpy(chars), torch.from_numpy(lengths))
    want = lib.expected_plane(np.array([re.search(lib.PY_PATTERN, bytes(chars[i, :n]), re.DOTALL)
                                        is not None for i, n in enumerate(lengths)]),
                              torch.device("cpu"))
    assert torch.equal(lib.marker_match_plain(stack), want)
    assert torch.equal(lib.marker_chunks_plain(stack, 8), want)


def test_compose_is_associative():
    rng = np.random.default_rng(7)
    a, b, c = ([torch.from_numpy(rng.integers(-2**31, 2**31, size=(5,), dtype=np.int64)
                                 .astype(np.int32)) for _ in lib.SUMMARY] for _ in range(3))
    left = lib.compose(lib.compose(a, b), c)
    right = lib.compose(a, lib.compose(b, c))
    assert all(torch.equal(x, y) for x, y in zip(left, right))


def _mutant(stack: torch.Tensor, drop: str) -> torch.Tensor:
    """A copy of the plain verdict with the end-plane AND or the cr term of
    the line start dropped."""
    c = lib._classes(stack)
    sd = lib._shift_down
    first = torch.zeros_like(stack[8])
    first[0] = -1
    lf1 = sd(c["lf"], 1)
    linestart = first | (lf1 if drop == "cr" else sd(c["cr"], 2) & lf1)
    k = linestart & c["f"]
    for nm in ("r", "o", "m", "colon"):
        k = sd(k) & c[nm]
    ns = lib._affine_scan(c["name"], sd(k) & c["name"])
    ds = lib._affine_scan(c["dom"], sd(c["at"] & sd(ns)) & c["dom"])
    done = sd(sd(ds) & c["cr"]) & c["lf"]
    if drop != "end":
        done = done & stack[9]
    out = done[0]
    for i in range(1, done.shape[0]):
        out = out | done[i]
    return out


@pytest.mark.parametrize("drop", ["end", "cr"])
def test_body_tells_mutants_apart(drop):
    B, L = 4096, 96
    want = _body("probe_tpu57.py", B, L, "near")
    stack = torch.from_numpy(_stack("near", B, L))
    assert np.array_equal(_mutant(stack, "none").numpy(), want)  # the copy unmutated
    assert not np.array_equal(_mutant(stack, drop).numpy(), want)


def test_entry_point_refuses_bad_stacks():
    stack = torch.from_numpy(_stack("near", 4096, 64))
    bad = [lambda: lib.marker_match(stack[:, :, :48].contiguous(), 8),  # NW % 32
           lambda: lib.marker_match(stack, 24),  # 24 does not divide 64
           lambda: lib.marker_match(stack.long(), 8),
           lambda: lib.marker_match(stack[:9], 8),
           lambda: lib.marker_match_cuda(stack, 8)]  # a CPU stack to the kernel
    for call in bad:
        with pytest.raises(ValueError):
            call()


# ------------------------------------------------- the chunked kernel's split


def _marker_cu(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (Path(kernels.CSRC) / "probe_marker.cu").read_text())
    assert m, name
    return int(m.group(1))


def test_geometry_follows_the_source():
    """The lib's constants are the kernel's, and its split of L = 1024
    (16 blocks, each 64 positions in one round) and of the odd lengths
    the tests use."""
    assert (lib.SPAN, lib.MAX_CLUSTER, lib.HALO, lib.AHEAD) == (
        _marker_cu("kSpan"), _marker_cu("kMaxCluster"), _marker_cu("HALO"), _marker_cu("AHEAD"))
    assert [lib.geometry(1024, c) for c in lib.CHUNKS] == [(16, 8, 8), (16, 4, 4), (16, 2, 2),
                                                           (16, 1, 1)]
    assert [lib.geometry(96, c) for c in (8, 16, 32)] == [(12, 1, 1), (6, 1, 1), (3, 1, 1)]
    assert lib.geometry(2048, 8) == (16, 16, 8) and lib.geometry(2048, 64) == (16, 2, 1)
    assert lib.geometry(136, 8) == (1, 17, 1)  # 17 chunks: one block, 17 rounds


SPLITS = [(L, c) for L in (64, 96, 136, 1024, 2048) for c in lib.CHUNKS if L % c == 0]


@pytest.mark.parametrize("L,chunk", SPLITS)
@pytest.mark.parametrize("NW", [32, 64])
def test_cluster_fold_equals_plain(NW, L, chunk):
    B = 32 * NW
    stack = torch.from_numpy(_stack("near", B, L))
    want = lib.marker_match_reduced_plain(stack)
    assert torch.equal(want, torch.from_numpy(_want_re("near", B, L)))
    assert torch.equal(lib.marker_chunks_plain(stack, chunk), want)
    assert torch.equal(lib.marker_match(stack, chunk), want)


def test_blocks_out_of_order_are_told_apart():
    L, chunk, B = 96, 8, 1024
    stack = torch.from_numpy(_stack("near", B, L))
    K, NB, _ = lib.geometry(L, chunk)
    s = lib.chunk_summaries(stack, chunk)
    blocks = [lib.fold([tuple(f[k] for f in s) for k in range(r * NB, (r + 1) * NB)])
              for r in range(K)]
    assert torch.equal(lib.fold(blocks)[5], lib.marker_match_reduced_plain(stack))
    blocks[0], blocks[1] = blocks[1], blocks[0]
    assert not torch.equal(lib.fold(blocks)[5], lib.marker_match_reduced_plain(stack))
