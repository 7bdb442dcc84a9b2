"""The port's native host oracle (``native/scan.cpp``) against the JAX
package's (``halo2_regex_tpu/native/scan.cpp``).

``scan_states``, ``substr_scan``, ``mask_fsm`` and
``match_substrs_native`` of ``halo2_regex_tpu_torch.native`` are held
against those of ``halo2_regex_tpu.native`` on the cases of
tests/test_native.py (the regex1+2 strings and the fuzz) and of
tests/test_fuzz_configs.py (random configs), key by key with dtypes, and
``match_substrs_native`` against the port's ``BatchMatcher`` on the
columns both return.  Tests skip only where no g++ exists, as the JAX
package's do.
"""

import numpy as np
import pytest

import halo2_regex_tpu as J
from halo2_regex_tpu import native as jnative

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch import native

from fixtures import CONFIGS
from test_fuzz_configs import MAX_LEN as FUZZ_LEN
from test_fuzz_configs import random_config

MAX_LEN = 64
REGEX12_STRINGS = [
    b"email was meant for @y. Also for x.",
    b"email was meant for @@",
    b"",
    b"email was meant for @yajk. Also for swq.",
]


@pytest.fixture(scope="module")
def models():
    """The regex1+2 model of each package at L=64, arrays equal."""
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain for the native oracle")
    cfgs = [CONFIGS["regex1"], CONFIGS["regex2"]]
    pair = tuple(pkg.CompiledRegexModel.from_decomposed(
        [pkg.DecomposedRegexConfig.from_json(c) for c in cfgs], max_chars_size=MAX_LEN)
        for pkg in (J, T))
    for k in ("transition", "substr_id_table", "is_start_table", "is_end_table"):
        assert np.array_equal(getattr(pair[0], k), getattr(pair[1], k)), k
    return pair


def _fuzz(rng, base, n, L):
    alphabet = np.array(sorted(set(range(32, 127)) | {9, 10, 13}), np.uint8)
    strings = []
    for _ in range(n):
        s = bytearray(rng.choice(alphabet, size=int(rng.integers(0, L))))
        if rng.random() < 0.5:
            k = int(rng.integers(0, len(base)))
            s = bytearray(base[:k]) + s[: L - k]
        strings.append(bytes(s[:L]))
    return strings


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["strings", "fuzz", "past_length"])
def test_match_substrs_native_equals_jax(models, case):
    jm, tm = models
    if case == "strings":
        chars, lengths = T.pack_batch(REGEX12_STRINGS, MAX_LEN)
    else:
        rng = np.random.default_rng(7)
        chars, lengths = T.pack_batch(
            _fuzz(rng, b"email was meant for @abc. Also for de.", 64, MAX_LEN), MAX_LEN)
        if case == "past_length":  # bytes past each length are never read
            for i in range(chars.shape[0]):
                chars[i, lengths[i]:] = rng.integers(1, 256, size=MAX_LEN - lengths[i])
    got = native.match_substrs_native(tm, chars, lengths)
    _same(got, jnative.match_substrs_native(jm, chars, lengths))
    assert got["substr_id_sum"].any() and (case != "strings" or got["mask"].any())
    res = T.BatchMatcher(tm, device="cpu")(chars, lengths)
    for k, v in got.items():  # the columns the portable scan shares
        assert np.array_equal(getattr(res, k).numpy(), v), k


@pytest.mark.parametrize("seed", [99, 3, 5])
def test_random_configs_equal_jax(seed):
    """tests/test_fuzz_configs.py:117's random configs (seed 99 there)."""
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain for the native oracle")
    rng = np.random.default_rng(seed)
    cfg_json, gens = random_config(rng)
    try:
        pair = [pkg.CompiledRegexModel.from_decomposed(
            pkg.DecomposedRegexConfig.from_json(cfg_json), max_chars_size=FUZZ_LEN)
            for pkg in (J, T)]
    except Exception:
        pytest.skip("degenerate random config")
    strings = [("".join(g() for g in gens)).encode()[:FUZZ_LEN] for _ in range(8)]
    chars, lengths = T.pack_batch(strings, FUZZ_LEN)
    _same(native.match_substrs_native(pair[1], chars, lengths),
          jnative.match_substrs_native(pair[0], chars, lengths))


def test_passes_equal_jax(models):
    """Each native pass alone: the scan of each def, its tagging, and the
    FSMs on the summed columns."""
    jm, tm = models
    rng = np.random.default_rng(2)
    chars, lengths = T.pack_batch(
        _fuzz(rng, b"email was meant for @q. Also for z.", 40, MAX_LEN), MAX_LEN)
    sums = [np.zeros((40, MAX_LEN), np.int32), np.zeros((40, MAX_LEN + 1), np.int32),
            np.zeros((40, MAX_LEN + 1), np.int32)]
    for d in range(tm.n_defs):
        args = (chars, lengths, tm.transition[d], int(tm.first_states[d]),
                int(tm.dummy_states[d]))
        raw = native.scan_states(*args)
        assert raw.dtype == np.int32 and np.array_equal(raw, jnative.scan_states(*args))
        args = (raw, lengths, tm.substr_id_table[d], tm.is_start_table, tm.is_end_table)
        got, want = native.substr_scan(*args), jnative.substr_scan(*args)
        for g, w, acc in zip(got, want, sums):
            assert g.dtype == np.int32 and np.array_equal(g, w)
            acc += g
    got, want = native.mask_fsm(*sums), jnative.mask_fsm(*sums)
    assert all(g.dtype == np.int32 and np.array_equal(g, w) for g, w in zip(got, want))
    assert got[2].any()


def test_bindings_refuse_bad_shapes(models):
    _jm, tm = models
    chars = np.zeros((2, 8), np.uint8)
    with pytest.raises(ValueError, match="lengths"):
        native.scan_states(chars, np.array([9, 0]), tm.transition[0], 0, 1)
    with pytest.raises(ValueError, match="transition"):
        native.scan_states(chars, np.array([1, 0]), tm.transition[0][:5], 0, 1)
    raw = np.zeros((2, 9), np.int32)
    with pytest.raises(ValueError, match="states"):
        native.substr_scan(raw + tm.s_pad, np.array([1, 0]), tm.substr_id_table[0],
                           tm.is_start_table, tm.is_end_table)
    with pytest.raises(ValueError, match="flag sums"):
        native.mask_fsm(np.zeros((2, 8)), np.zeros((2, 8)), np.zeros((2, 9)))
