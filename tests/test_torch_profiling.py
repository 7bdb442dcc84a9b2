"""The port's ``utils/profiling.py`` against the JAX package's.

The same inputs go through ``halo2_regex_tpu.utils.profiling`` and
``halo2_regex_tpu_torch.utils.profiling``: the CPU's specs, the roofline
arithmetic, ``result_nbytes`` of both packages' results on one seeded
from: batch (the JAX witness in interpret mode, as its own tests run it)
and the host-clock timers under one deterministic clock are exactly
equal.  The card's row, its matching and ``time_ms`` on the CPU have no
JAX counterpart and are checked alone.  The card cases are in
tests/test_torch_cuda.py.
"""

import itertools
import time

import jax
import numpy as np
import pytest
import torch

import halo2_regex_tpu as J
import halo2_regex_tpu_torch as T
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxBitplane
from halo2_regex_tpu.utils import profiling as jp
from halo2_regex_tpu_torch.utils import profiling as tp

L, B = 128, 8


@pytest.fixture(scope="module")
def batch():
    """A seeded from: batch at L = 128: filler, then a from: line."""
    rng = np.random.default_rng(25)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    chars = np.zeros((B, L), np.uint8)
    lengths = np.zeros((B,), np.int32)
    for i in range(B):
        s = (rng.choice(alpha, size=int(rng.integers(0, 48))).tobytes() + b"\r\nfrom:"
             + rng.choice(alpha[:26], size=8).tobytes() + b"@x.yz\r\n")
        if i % 3 == 2:
            s = s[:-2]  # no closing \r\n: no match
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@pytest.fixture(scope="module")
def models():
    return (J.zoo.email_headers_model(max_chars_size=L, headers=("from",)),
            T.zoo.email_headers_model(max_chars_size=L, headers=("from",)))


@pytest.fixture(scope="module")
def results(batch, models):
    """Both packages' ``RegexResult`` (``BatchMatcher``) and witness dict
    (``BitplaneMatcher(columns="witness")``) on the batch."""
    chars, lengths = batch
    jm, tm = models
    return {
        "regex_result": (J.BatchMatcher(jm)(chars, lengths),
                         T.BatchMatcher(tm, device="cpu")(chars, lengths)),
        "witness": (JaxBitplane(jm, columns="witness", interpret=True)(chars, lengths),
                    T.BitplaneMatcher(tm, columns="witness", device="cpu")(chars, lengths)),
    }


def test_device_specs_cpu_equals_jax():
    want = jp.device_specs(jax.devices("cpu")[0])
    for dev in ("cpu", torch.device("cpu")):
        got = tp.device_specs(dev)
        for key in ("hbm_gbps", "bf16_flops", "int8_ops", "kind"):
            assert got[key] == want[key], key


@pytest.mark.parametrize("traffic", [None, (1.0, 5.0), (1.0, 2.0), (0.5, 17.0)])
def test_scan_traffic_and_roofline_equal_jax(traffic):
    jt = tt = None
    if traffic is not None:
        jt, tt = jp.ScanTraffic(*traffic), tp.ScanTraffic(*traffic)
        assert tt.total == jt.total
    assert tp.ScanTraffic().total == jp.ScanTraffic().total == 6.0
    want = jp.scan_roofline_bytes_per_sec(jax.devices("cpu")[0], jt)
    assert tp.scan_roofline_bytes_per_sec("cpu", tt) == want


@pytest.mark.parametrize("kind", ["regex_result", "witness"])
def test_result_nbytes_equals_jax(results, kind):
    """Key by key first (a dtype or shape that differs names its field),
    then the sums."""
    jr, tr = results[kind]
    if kind == "regex_result":
        jd, td = vars(jr), vars(tr)
    else:
        jd, td = jr, tr
    assert sorted(jd) == sorted(td)
    for key in jd:
        assert tp.result_nbytes(td[key]) == jp.result_nbytes(jd[key]), key
    assert tp.result_nbytes(tr) == jp.result_nbytes(jr) > 0
    # numpy rows of the same result count the same
    assert tp.result_nbytes(tr.to_numpy() if kind == "regex_result"
                            else {k: v.numpy() for k, v in tr.items()}) == jp.result_nbytes(jr)


def test_result_nbytes_of_mixed_leaves():
    """``None`` is no leaf; an int counts as its numpy scalar; nested
    lists and tuples are walked."""
    tree = {"none": None, "int": 3, "arr": np.zeros((5, 3), np.int16),
            "nested": [np.ones(4, np.uint8), (7.5, None)]}
    assert tp.result_nbytes(tree) == jp.result_nbytes(tree) == 8 + 30 + 4 + 8
    assert tp.result_nbytes({"t": torch.zeros(6, dtype=torch.int32), "n": None}) == 24


def _clock(monkeypatch):
    """``time.perf_counter`` as 0, 0.001, 0.003, 0.006, ... (each step a
    millisecond longer than the last), shared by both modules."""
    steps = itertools.accumulate(itertools.count(0), lambda t, i: t + i * 1e-3)
    monkeypatch.setattr(time, "perf_counter", lambda: next(steps))


def test_benchmark_equals_jax(monkeypatch):
    x = np.arange(12, dtype=np.int32)
    got = {}
    for name, mod, arg in (("jax", jp, jax.numpy.asarray(x)), ("torch", tp, torch.from_numpy(x))):
        _clock(monkeypatch)
        got[name] = mod.benchmark(lambda a: {"y": a + 1, "z": None}, arg, iters=7, warmup=2)
    assert got["torch"] == got["jax"] > 0


def test_benchmark_chained_equals_jax(monkeypatch):
    x = np.arange(12, dtype=np.int32)

    def chained(k):
        def f(a):
            for _ in range(k):
                a = a * 3 + 1
            return a
        return f

    got = {}
    for name, mod, arg in (("jax", jp, jax.numpy.asarray(x)), ("torch", tp, torch.from_numpy(x))):
        _clock(monkeypatch)
        got[name] = mod.benchmark_chained(chained, (arg,), ks=(1, 8), warmup=1)
    assert got["torch"] == got["jax"] > 0


def test_fetch_takes_one_element_of_the_first_leaf():
    out = tp._fetch({"a": torch.arange(5, 10), "b": np.zeros(3)})
    assert out.tolist() == [5]
    assert tp._fetch({"a": None}) is None
    assert tp._fetch(np.arange(4, dtype=np.int8)).tolist() == [0]


def test_the_card_row():
    h = tp.spec_for_kind("NVIDIA H100 80GB HBM3")
    assert (h["hbm_gbps"], h["bf16_flops"], h["int8_ops"], h["sm_count"], h["clock_hz"],
            h["l2_bytes"], h["kind"]) == (3.35e12, 989e12, 1979e12, 132, 1.98e9,
                                          50 * 1024 * 1024, "NVIDIA H100 80GB HBM3")
    assert h["int32_ops"] == 132 * 64 * 1.98e9
    assert h["half2_instrs"] == 132 * 128 * 1.98e9
    assert tp.spec_for_kind(tp.H100_KIND) == h
    # the port states no TPU rate
    assert not any("tpu" in key.lower() for key in tp._DEVICE_SPECS)


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA H100", "NVIDIA A100-SXM4-80GB",
                                  "TPU v5 lite"])
def test_an_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak specs"):
        tp.spec_for_kind(kind)


def test_device_specs_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py checks its row")
    with pytest.raises(RuntimeError, match="is_available"):
        tp.device_specs()
    with pytest.raises(RuntimeError):
        tp.scan_roofline_bytes_per_sec()


@pytest.mark.parametrize("warmup,iters", [(0, 1), (2, 10), (3, 4)])
def test_time_ms_on_the_cpu(warmup, iters):
    calls = []
    t = tp.time_ms(lambda: calls.append(1), device="cpu", warmup=warmup, iters=iters)
    assert len(calls) == warmup + iters
    assert t["runs"] == iters == len(t["all"])
    assert t["iqr"][0] <= t["median"] <= t["iqr"][1]
    assert all(ms >= 0 for ms in t["all"])
