"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On a machine with an
NVIDIA GPU and nvcc, run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax, which the GPU
machine need not have; this file imports no JAX.)  Bit-exact: integer
outputs, tolerance 0.
"""

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
    launch once each, and no other kernel does."""
    model = _model(name, L)
    chars, lengths = _corpus(4099, L, 2)
    m = T.BitplaneMatcher(model, columns=columns, device=dev)
    kernels.reset_launch_counts()
    got = m(chars, lengths)
    torch.cuda.synchronize()
    path = kernels.path_kernels(m.plan)
    assert {k.name: k.launches for k in kernels.KERNELS} == {
        k.name: int(k in path) for k in kernels.KERNELS}
    _assert_same(got, T.BitplaneMatcher(model, columns=columns)(chars, lengths))


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
