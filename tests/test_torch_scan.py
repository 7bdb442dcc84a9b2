"""The PyTorch port's portable scan against the JAX package's.

``halo2_regex_tpu_torch.ops.scan_torch`` (``BatchMatcher``, ``scan_states``,
``prefix_transition_maps``, ``mask_fsm``, ``expand_rows``) is held against
``halo2_regex_tpu.ops.scan_jax`` on the cases of tests/test_jax_scan.py
(the regex1+2 and regex3 strings, row-wise batches, the fuzz, the save and
load round trip), on batches with nonzero bytes past each length, and on
a model of 300 states; the device ``tile_corpus`` against the host one,
and the device-expand ``ScanJob`` against the host-packed one and JAX's.
The JAX and port models are built from the same configs and their arrays
asserted equal first.  Everything runs on the CPU (``device="cpu"``: the
plain scan); the card's kernel path is held to that plain pipeline in
tests/test_torch_cuda.py and chip_smoke.py.  All outputs are integers or
booleans: tolerance 0, dtypes included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.models.defs import AllstrRegexDef as JAllstr
from halo2_regex_tpu.models.defs import RegexDefs as JRegexDefs
from halo2_regex_tpu.ops import scan_jax
from halo2_regex_tpu.ops.bitplane import tile_corpus as jax_tile_corpus
from halo2_regex_tpu.utils.jobs import ScanJob as JaxScanJob

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops import scan_torch as st
from halo2_regex_tpu_torch.utils.jobs import ScanJob

from test_torch_bitplane import _build, corpus
from test_torch_pallas import _large

MAX_LEN = 64
FIELDS = T.RegexResult.field_names()
MODEL_ARRAYS = ("transition", "substr_id_table", "first_states", "accepted_states",
                "accept_mask", "dummy_states", "dead_states", "is_start_table", "is_end_table")

TEST_STRINGS_12 = [
    b"email was meant for @y. Also for x.",
    b"email was meant for @yajk. Also for swq.",
    b"email was meant for @@",
    b"",
    b"a",
]
TEST_STRINGS_3 = [
    b"from:alice@gmail.com\r\n",
    b"dummy\r\nfrom:alice<alice@gmail.com>\r\n",
    b"from:alice<alicegmail.com>\r\n",
    b"from:alice<alice@gmail.com>",
    b"fromalice<alice@gmail.com>\r\n",
    bytes([0, 1, 2]),
]


def _pair(name):
    """(JAX model, port model) of one name, their arrays equal."""
    if name == "large":
        pair = (_large(JAllstr, JRegexDefs, J.CompiledRegexModel),
                _large(AllstrRegexDef, RegexDefs, T.CompiledRegexModel))
    else:
        pair = _build(J, jzoo, name), _build(T, T.zoo, name)
    for k in MODEL_ARRAYS:
        a, b = (np.asarray(getattr(m, k)) for m in pair)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    return pair


@pytest.fixture(scope="module")
def matchers():
    """name -> (JAX BatchMatcher, the port's on the CPU); each JAX matcher
    compiles once a shape for the module."""
    out = {}
    for name in ("two_def", "regex3", "from", "large"):
        jm, tm = _pair(name)
        out[name] = scan_jax.BatchMatcher(jm), T.BatchMatcher(tm, device="cpu")
    return out


def assert_same(got, want, what=""):
    """Every field of a port RegexResult (tensors) equals the JAX one's,
    shape and dtype included."""
    for f in FIELDS:
        a = getattr(got, f)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, b.dtype, a.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} field {f}")


def _both(matchers, name, chars, lengths):
    jm, tm = matchers[name]
    return tm(chars, lengths), jm(chars, lengths)


@pytest.mark.parametrize("s", TEST_STRINGS_12)
def test_batch_matcher_vs_jax_12(matchers, s):
    jm, tm = matchers["two_def"]
    assert_same(tm.match_one(s), jm.match_one(s), s)


@pytest.mark.parametrize("s", TEST_STRINGS_3)
def test_batch_matcher_vs_jax_3(matchers, s):
    jm, tm = matchers["regex3"]
    assert_same(tm.match_one(s), jm.match_one(s), s)


def test_batched_rowwise(matchers):
    strings = TEST_STRINGS_3 + [b"from:bob@x.yz\r\n"]
    chars, lengths = T.pack_batch(strings, MAX_LEN)
    got, want = _both(matchers, "regex3", chars, lengths)
    assert_same(got, want)
    jm, tm = matchers["regex3"]
    for i, s in enumerate(strings):  # each row equals the string alone
        assert_same(got.map(lambda a: a[i]), jm.match_one(s), s)


def test_fuzz_random_inputs(matchers):
    """tests/test_jax_scan.py's fuzz: 48 random strings over the fixture
    alphabet, half biased toward near-matches."""
    rng = np.random.default_rng(0)
    alphabet = np.array(sorted(set(range(32, 127)) | {9, 10, 13}), dtype=np.uint8)
    base = b"email was meant for @q. Also for z."
    strings = []
    for _ in range(48):
        ln = int(rng.integers(0, MAX_LEN))
        s = bytearray(rng.choice(alphabet, size=ln))
        if rng.random() < 0.5:
            k = int(rng.integers(0, len(base)))
            s = bytearray(base[:k]) + s[: MAX_LEN - k]
        strings.append(bytes(s[:MAX_LEN]))
    chars, lengths = T.pack_batch(strings, MAX_LEN)
    got, want = _both(matchers, "two_def", chars, lengths)
    assert_same(got, want)
    assert bool(np.asarray(want.substr_id_sum).any())


@pytest.mark.parametrize("name", ["two_def", "regex3", "from", "large"])
def test_bytes_past_the_length(matchers, name):
    """Seeded corpora whose buffers hold nonzero bytes past each length
    (JAX scans the raw chars there); the 300-state model takes the class
    map of a model beyond 256 states."""
    if name == "large":
        rng = np.random.default_rng(4)
        chars = rng.integers(97, 103, size=(24, MAX_LEN)).astype(np.uint8)
        lengths = rng.integers(0, MAX_LEN + 1, size=24).astype(np.int32)
        chars[3, 5] = 7  # a byte outside the alphabet: the dead state
    else:
        chars, lengths = corpus(name, 24, 9)
        rng = np.random.default_rng(5)
    for i in range(chars.shape[0]):
        chars[i, lengths[i]:] = rng.integers(1, 256, size=MAX_LEN - lengths[i])
    got, want = _both(matchers, name, chars, lengths)
    assert_same(got, want, name)
    if name != "large":
        assert bool(np.asarray(want.mask).any())


def test_large_model_tables(matchers):
    """The 300-state model's class map: the widest def's distinct rows
    (six bytes and the dead row), padded to 8."""
    tm = matchers["large"][1]
    assert tm.model.s_pad > 256
    assert tuple(tm.next_table.shape) == (1, 8, tm.model.s_pad)
    assert tm.next_table16 is not None


def test_model_save_load_roundtrip(tmp_path, matchers):
    jm, tm = matchers["regex3"]
    path = tmp_path / "model.npz"
    tm.model.save(path)
    loaded = T.CompiledRegexModel.load(path)
    for k in MODEL_ARRAYS:
        np.testing.assert_array_equal(getattr(loaded, k), getattr(jm.model, k))
    s = b"from:alice@gmail.com\r\n"
    assert_same(T.BatchMatcher(loaded, device="cpu").match_one(s), jm.match_one(s))


@pytest.mark.parametrize("name", ["two_def", "large"])
def test_scan_states_and_prefix_maps(matchers, name):
    """``scan_states`` of each def and ``prefix_transition_maps`` of single
    strings equal JAX's."""
    jm, tm = matchers[name]
    model = tm.model
    rng = np.random.default_rng(11)
    lo, hi = (97, 103) if name == "large" else (32, 127)
    chars = rng.integers(lo, hi, size=(9, MAX_LEN)).astype(np.uint8)
    for d in range(model.n_defs):
        t = model.transition[d]
        got = st.scan_states(t, int(model.first_states[d]), chars)
        want = np.asarray(scan_jax.scan_states(jnp.asarray(t), int(model.first_states[d]),
                                               jnp.asarray(chars)))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        for n in (1, 2, 5, 37, MAX_LEN):
            row = chars[n % 9, :n].astype(np.int32)
            got = st.prefix_transition_maps(torch.from_numpy(t), torch.from_numpy(row))
            want = np.asarray(scan_jax.prefix_transition_maps(jnp.asarray(t), jnp.asarray(row)))
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), (d, n)


def _fsm_loop(set_, reset, reverse):
    """The recurrence step by step (JAX's ``lax.scan`` body)."""
    out = torch.zeros(set_.shape, dtype=torch.int32)
    last = torch.zeros(set_.shape[1:], dtype=torch.int32)
    steps = range(set_.shape[0] - 1, -1, -1) if reverse else range(set_.shape[0])
    for i in steps:
        last = torch.where(set_[i], 1, torch.where(reset[i], 0, last)).to(torch.int32)
        out[i] = last
    return out


@pytest.mark.parametrize("case", ["random", "dense", "all_set", "all_reset", "empty", "one",
                                  "long"])
@pytest.mark.parametrize("reverse", [False, True])
def test_mask_fsm_equals_the_loop(case, reverse):
    rng = np.random.default_rng(len(case) + 10 * reverse)
    L, B = {"one": (1, 5), "long": (1000, 3)}.get(case, (70, 33))  # 1, 2 and 16 chunks
    p = 0.5 if case == "dense" else 0.08
    s = torch.from_numpy(rng.random((L, B)) < p)
    r = torch.from_numpy(rng.random((L, B)) < p)
    if case == "all_set":
        s = torch.ones_like(s)
    elif case == "all_reset":
        s, r = torch.zeros_like(s), torch.ones_like(r)
    elif case == "empty":
        s, r = torch.zeros_like(s), torch.zeros_like(r)
    got = st.mask_fsm(s, r, reverse)
    assert got.dtype == torch.int32
    assert torch.equal(got, _fsm_loop(s, r, reverse))


def test_expand_rows_matches_jax():
    rng = np.random.default_rng(3)
    flat = rng.integers(1, 256, size=500).astype(np.uint8)
    starts = rng.integers(0, 400, size=17).astype(np.int64)
    lengths = rng.integers(0, 33, size=17).astype(np.int32)
    lengths[:3] = (0, 32, 1)
    got = st.expand_rows(torch.from_numpy(flat), torch.from_numpy(starts),
                         torch.from_numpy(lengths), 32)
    want = np.asarray(scan_jax.expand_rows(jnp.asarray(flat), jnp.asarray(starts),
                                           jnp.asarray(lengths), 32))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_expand_rows_refuses_a_2gib_buffer():
    flat = torch.zeros(1, dtype=torch.uint8).expand(2**31)  # no memory behind it
    with pytest.raises(ValueError, match="exceeds int32 indexing"):
        st.expand_rows(flat, torch.zeros(1, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int32), 8)


@pytest.mark.parametrize("B,L,L_pad", [(37, 64, 128), (4099, 100, 128), (8192, 128, 128)])
def test_tile_corpus_device_equals_host(B, L, L_pad):
    rng = np.random.default_rng(B)
    chars = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    got = bp.tile_corpus_device(torch.from_numpy(chars), L_pad)
    want = T.tile_corpus(chars, L_pad)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jax_tile_corpus(chars, L_pad))


def test_scan_job_device_expand_parity(tmp_path, matchers):
    """tests/test_io.py's device-expand parity on the port's BatchMatcher:
    the same counters and (string, verdict) rows as the host-packed job,
    and as the JAX device-expand job."""
    model = _build(T, T.zoo, "regex3", L=32)
    matcher = T.BatchMatcher(model, device="cpu")
    corpus_ = tmp_path / "c.txt"
    lines = [b"from:a@b.cd\r", b"nope", b"from:x@y.zw\r", b""] * 7
    corpus_.write_bytes(b"\n".join(lines) + b"\n")
    inputs = {"host": [], "dev": []}

    def collect(key):
        def cb(res, chars, lengths, n_valid):
            for i in range(n_valid):
                inputs[key].append((bytes(np.asarray(chars)[i][: lengths[i]]),
                                    bool(res.match_ok[i])))
        return cb

    def stable(c):
        return {k: v for k, v in c.snapshot().items() if k != "wall_seconds"}

    a, b = (ScanJob(matcher, [str(corpus_)], batch_size=8, keep_newline=True, device_expand=dx,
                    on_batch=collect(key), chunk_bytes=64).run()
            for dx, key in ((False, "host"), (True, "dev")))
    jax_job = JaxScanJob(scan_jax.BatchMatcher(_build(J, jzoo, "regex3", L=32)), [str(corpus_)],
                         batch_size=8, keep_newline=True, device_expand=True,
                         chunk_bytes=64).run()
    assert stable(a) == stable(b) == stable(jax_job)
    assert inputs["host"] == inputs["dev"]
    assert any(ok for _, ok in inputs["host"])


def test_exports():
    """The port exports the names of the JAX ``__init__`` that this slice
    ports."""
    assert {"BatchMatcher", "pack_batch"} <= set(T.__all__) & set(J.__all__)
    assert T.BatchMatcher is st.BatchMatcher
    chars, lengths = T.pack_batch([b"ab", b""], 4)
    want = J.pack_batch([b"ab", b""], 4)
    assert np.array_equal(chars, want[0]) and np.array_equal(lengths, want[1])


def test_batch_matcher_needs_cuda_unless_asked_for_the_cpu(matchers, monkeypatch):
    """The card is the default device: without CUDA the constructor raises,
    as the other matchers' do; ``device="cpu"`` runs the plain scan."""
    model = matchers["regex3"][1].model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.BatchMatcher(model)
    assert T.BatchMatcher(model, device="cpu").device.type == "cpu"
