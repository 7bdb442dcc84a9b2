"""The port's witness host layer, prover hand-off and circom against the JAX
package's, on the same inputs, with exact equality (text for text, arrays
with their dtypes).

Covers ``witness/tables.py`` (``build_all_tables``), ``witness/checker.py``
(``check_witness``, ``check_witness_batch``, ``verify``: good witnesses and
one lookup row tampered in each of (iii), (iv) and (v)),
``witness/expand.py`` (the port's CPU compact witness against JAX's
``expand_witness`` of JAX's interpret-mode witness), ``witness/io.py`` (npz
files cross-loaded both ways, member bytes equal), ``witness/handoff.py``
(dump text, parse, ``verify_handoff``'s structural errors), the port's
C++ ``handoff_check`` (skips only where no g++ exists), ``gen_circom`` and
``CircomSim`` on the fixtures of tests/test_circom.py, and
``RegexResult.to_numpy``'s dtypes.
"""

import shutil
import zipfile

import halo2_regex_tpu as J
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_regex_tpu.compiler.circom import gen_circom as jgen_circom
from halo2_regex_tpu.compiler.circom_sim import CircomSim as JCircomSim
from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig as JConfig
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.models.compiled import CompiledRegexModel as JModel
from halo2_regex_tpu.ops import reference as jref
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JBitplane
from halo2_regex_tpu.ops.scan_jax import BatchMatcher as JBatch
from halo2_regex_tpu.witness import checker as jchecker
from halo2_regex_tpu.witness import handoff as jhandoff
from halo2_regex_tpu.witness import io as jio
from halo2_regex_tpu.witness.expand import expand_witness as jexpand
from halo2_regex_tpu.witness.tables import build_all_tables as jtables

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch import native
from halo2_regex_tpu_torch.compiler.circom import gen_circom
from halo2_regex_tpu_torch.compiler.circom_sim import CircomSim
from halo2_regex_tpu_torch.ops import reference as tref
from halo2_regex_tpu_torch.witness import handoff
from halo2_regex_tpu_torch.witness.result import RegexResult

from fixtures import CONFIGS, EXAMPLE_CONFIG

MAX_LEN = 64
GOLDEN = Path(__file__).parent / "golden"
STRINGS = [
    b"from:alice@gmail.com\r\n",
    b"dummy\r\nfrom:alice<alice@gmail.com>\r\n",
    b"from:alice<alicegmail.com>\r\n",
    b"",
    b"fromalice<alice@gmail.com>\r\n",
    b"from:bob@x.yz\r\n",
    b"x" * MAX_LEN,
    b"from:carol.d@sub.domain-x.org\r\n",
]
INPUT = b"from:alice@gmail.com\r\n"
META = {"fixture": "regex3_test.json", "input": "from:alice@gmail.com\\r\\n",
        "max_chars_size": "64"}


def _models(names, L=MAX_LEN):
    return (JModel.from_decomposed([JConfig.from_json(CONFIGS[n]) for n in names],
                                   max_chars_size=L),
            T.CompiledRegexModel.from_decomposed(
                [T.DecomposedRegexConfig.from_json(CONFIGS[n]) for n in names],
                max_chars_size=L))


@pytest.fixture(scope="module")
def models():
    return {"regex3": _models(["regex3"]), "two_def": _models(["regex1", "regex2"])}


@pytest.fixture(scope="module")
def batch():
    return T.pack_batch(STRINGS, MAX_LEN)


@pytest.fixture(scope="module")
def results(models, batch):
    """The regex3 batch through each package's portable scan: (JAX's
    RegexResult of numpy arrays, the port's of CPU tensors)."""
    jm, tm = models["regex3"]
    return JBatch(jm)(*batch).to_numpy(), T.BatchMatcher(tm, device="cpu")(*batch)


def _same(got, want, what=""):
    got = got if isinstance(got, dict) else vars(got)
    want = want if isinstance(want, dict) else vars(want)
    assert list(got) == list(want), what
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["regex3", "two_def"])
def test_tables_equal_jax(models, name):
    jm, tm = models[name]
    want, got = jtables(jm.regex_defs), T.build_all_tables(tm.regex_defs)
    assert len(got) == len(want)
    for (gt, ge), (wt, we) in zip(got, want):
        _same(vars(gt), vars(wt), "transition")
        _same(vars(ge), vars(we), "endpoints")
        assert gt.as_rows() == wt.as_rows() and ge.as_rows() == we.as_rows()


def test_to_numpy_dtypes_equal_jax(results):
    """``RegexResult.to_numpy`` brings every column to numpy with the JAX
    dtypes (int32 columns, bool verdicts)."""
    want, got = results
    host = got.to_numpy()
    assert all(isinstance(v, np.ndarray) for v in vars(host).values())
    _same(host, want)


def test_checker_on_good_witnesses(models, batch, results):
    jm, tm = models["regex3"]
    for s in STRINGS:
        jr = jref.match_substrs(jm.regex_defs, s, MAX_LEN)
        tr = tref.match_substrs(tm.regex_defs, s, MAX_LEN)
        errs = T.check_witness(tm.regex_defs, tr)
        assert errs == jchecker.check_witness(jm.regex_defs, jr)
        assert T.verify(tm.regex_defs, tr) == jchecker.verify(jm.regex_defs, jr) == (not errs)
        assert errs == [] or not bool(jr.match_ok)
    want = jchecker.check_witness_batch(jm.regex_defs, results[0])
    got = T.check_witness_batch(tm.regex_defs, results[1])
    _same({"ok": got}, {"ok": want})
    np.testing.assert_array_equal(got, results[0].match_ok)
    one = results[1].map(lambda a: a[0])  # a single row (squeeze path)
    _same({"ok": T.check_witness_batch(tm.regex_defs, one)},
          {"ok": jchecker.check_witness_batch(jm.regex_defs, results[0].map(lambda a: a[0]))})


def _tamper(res: RegexResult, lookup: str, row: int) -> RegexResult:
    """One lookup row of string ``row`` made false: (iii) a state, (iv) a
    start flag on a position without a start, (v) an end flag alike."""
    r = res.map(lambda a: np.array(a, copy=True))
    if lookup == "iii":
        r.states[row, 0, 3] = (r.states[row, 0, 3] + 1) % 20
    elif lookup == "iv":
        i = int(np.flatnonzero(r.start_enable[row, 0] == 0)[0])
        r.start_enable[row, 0, i] = 1
    else:
        i = int(np.flatnonzero(r.end_enable[row, 0] == 0)[0])
        r.end_enable[row, 0, i] = 1
    return r


@pytest.mark.parametrize("lookup", ["iii", "iv", "v"])
def test_checker_catches_a_tampered_lookup_row(models, results, lookup):
    jm, tm = models["regex3"]
    jr, tr = (_tamper(r, lookup, 0) for r in (results[0], results[1].to_numpy()))
    one_j, one_t = (r.map(lambda a: a[0]) for r in (jr, tr))
    errs = T.check_witness(tm.regex_defs, one_t)
    assert errs == jchecker.check_witness(jm.regex_defs, one_j)
    assert any(e.startswith(f"lookup({lookup})") for e in errs), errs
    got = T.check_witness_batch(tm.regex_defs, tr)
    _same({"ok": got}, {"ok": jchecker.check_witness_batch(jm.regex_defs, jr)})
    assert not got[0] and got[1:].tolist() == results[0].match_ok[1:].tolist()


@pytest.fixture(scope="module")
def jax_witness(models, batch):
    jm, _ = models["regex3"]
    return JBitplane(jm, interpret=True, columns="witness")._run(*batch)


def test_expand_witness_equals_jax(models, batch, results, jax_witness):
    """The port's compact witness (CPU), expanded by the port, equals JAX's
    witness expanded by JAX, every column and dtype; the raw bytes may be
    a tensor."""
    jm, tm = models["regex3"]
    w = T.BitplaneMatcher(tm, columns="witness", device="cpu")(*batch)
    want = jexpand(jm, jax_witness, batch[0])
    got = T.expand_witness(tm, w, torch.from_numpy(batch[0]))
    _same(got, want)  # the sums are int64 in both, as numpy sums int32
    for k, v in vars(results[0]).items():  # the full column set's values
        np.testing.assert_array_equal(getattr(got, k).astype(np.int64), v.astype(np.int64), k)
    _same({"ok": T.check_witness_batch(tm.regex_defs, got)},
          {"ok": jchecker.check_witness_batch(jm.regex_defs, want)})


def _members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_npz_cross_loading(tmp_path, models, results):
    """A file saved by the port loads in the JAX package and one saved by
    JAX loads in the port, with equal defs, columns and tables; the two
    files of one result hold byte-identical members."""
    jm, tm = models["regex3"]
    want, got = results
    tp, jp = tmp_path / "port.npz", tmp_path / "jax.npz"
    T.save_witness(tp, tm.regex_defs, got)  # a result of tensors
    jio.save_witness(jp, jm.regex_defs, want)
    assert _members(tp) == _members(jp)
    for load, path in ((jio.load_witness, tp), (T.load_witness, jp), (T.load_witness, tp)):
        defs, res, tables = load(path)
        assert [d.allstr.to_text() for d in defs] == [d.allstr.to_text() for d in jm.regex_defs]
        assert [[s.to_text() for s in d.substrs] for d in defs] == [
            [s.to_text() for s in d.substrs] for d in jm.regex_defs]
        _same(res, want)
        j_tables = jio.load_witness(jp)[2]
        _same(tables, j_tables)
    assert all(T.check_witness_batch(T.load_witness(jp)[0], T.load_witness(jp)[1])
               == want.match_ok)


@pytest.fixture(scope="module")
def dumps(models):
    jm, tm = models["regex3"]
    jr = jref.match_substrs(jm.regex_defs, INPUT, MAX_LEN)
    row = T.BatchMatcher(tm, device="cpu")(*T.pack_batch([INPUT], MAX_LEN)).map(lambda a: a[0])
    return (jhandoff.dump_prover_rows(jm.regex_defs, jr, meta=META),
            handoff.dump_prover_rows(tm.regex_defs, row, meta=META))


def test_handoff_text_equals_jax(dumps):
    want, got = dumps
    assert got == want == (GOLDEN / "regex3_handoff.txt").read_text()
    sections = handoff.load_prover_rows(got)
    _same(sections, jhandoff.load_prover_rows(want))
    assert handoff.verify_handoff(sections) == jhandoff.verify_handoff(sections) == []
    with pytest.raises(ValueError) as te:
        handoff.load_prover_rows("# not a handoff\n")
    with pytest.raises(ValueError) as je:
        jhandoff.load_prover_rows("# not a handoff\n")
    assert str(te.value) == str(je.value)


def test_verify_handoff_errors_equal_jax(dumps):
    sections = handoff.load_prover_rows(dumps[1])
    states = sections["advice states def=0"].copy()
    states[3] = (states[3] + 1) % 20
    mc = sections["instance masked_characters"].copy()
    mc[-1] = 65
    bad = [
        {k: v for k, v in sections.items() if k != "advice characters"},
        dict(sections, **{"advice states def=0": sections["advice states def=0"][:-1]}),
        dict(sections, **{"advice substr_ids def=0": sections["advice substr_ids def=0"][:5]}),
        {k: v for k, v in sections.items() if not k.startswith("table transition")},
        dict(sections, **{"advice states def=0": states}),
        dict(sections, **{"instance masked_characters": mc}),
    ]
    for b in bad:
        errs = handoff.verify_handoff(b)
        assert errs and errs == jhandoff.verify_handoff(b)
    assert all("structure" in e for e in handoff.verify_handoff(bad[0]))
    assert any("lookup(iii)" in e for e in handoff.verify_handoff(bad[4]))
    assert any("instance" in e for e in handoff.verify_handoff(bad[5]))


def test_handoff_check_binary(tmp_path, dumps):
    """The port's C++ verifier accepts the dump and rejects a tampered one
    and a malformed one, as the JAX package's does."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the JAX package's C++ verifier test needs it too)")
    good = tmp_path / "good.txt"
    good.write_text(dumps[1])
    r = native.handoff_check(good)
    assert r.returncode == 0 and "clean" in r.stdout
    lines = dumps[1].splitlines()
    idx = lines.index("[advice states def=0]")
    lines[idx + 4] = str((int(lines[idx + 4]) + 1) % 20)
    bad = tmp_path / "bad.txt"
    bad.write_text("\n".join(lines) + "\n")
    r = native.handoff_check(bad)
    assert r.returncode == 1 and "lookup(iii)" in r.stderr
    trunc = tmp_path / "trunc.txt"
    trunc.write_text("\n".join(dumps[1].splitlines()[:40]) + "\n")
    assert native.handoff_check(trunc).returncode == 2
    assert native.handoff_check_binary().parent.parent.name == "native"


CIRCOM_CONFIGS = {
    "example": EXAMPLE_CONFIG,
    **{n: CONFIGS[n] for n in ("regex1", "regex2", "regex3")},
}


@pytest.mark.parametrize("name", [*CIRCOM_CONFIGS, "email_from", "email_to", "email_subject",
                                  "body_prefix"])
def test_gen_circom_equals_jax(tmp_path, name):
    if name in CIRCOM_CONFIGS:
        jc = JConfig.from_json(CIRCOM_CONFIGS[name])
        tc = T.DecomposedRegexConfig.from_json(CIRCOM_CONFIGS[name])
    else:
        jc = jzoo.get_config(name, max_byte_size=64)
        tc = T.zoo.get_config(name, max_byte_size=64)
    out = tmp_path / "t.circom"
    got = gen_circom(tc, out, "T")
    assert got == jgen_circom(jc, None, "T") == out.read_text()
    if name == "example":
        assert T.gen_circom(tc, None, "Test1Regex") == (GOLDEN / "test1_regex.circom").read_text()


CIRCOM_CASES = [
    ("regex3", b"from:alice@gmail.com\r\n"),
    ("regex3", b"dummy\r\nfrom:alice<alice@gmail.com>\r\n"),
    ("regex3", b"from:alice<alicegmail.com>\r\n"),
    ("regex3", b""),
    ("regex1", b"email was meant for @yajk."),
    ("regex2", b". Also for swq."),
]


@pytest.mark.parametrize("name,msg", CIRCOM_CASES)
def test_circom_sim_equals_jax(name, msg):
    text = gen_circom(T.DecomposedRegexConfig.from_json(CONFIGS[name]), None, "T")
    got, want = CircomSim(text, msg, 48), JCircomSim(text, msg, 48)
    for attr in ("inp", "states", "state_changed", "out", "reveals"):
        assert getattr(got, attr) == getattr(want, attr), attr
    if msg == b"from:alice@gmail.com\r\n":
        assert bytes(v for v in got.reveals[0] if v) == b"alice@gmail.com"


def test_all_holds_every_jax_name():
    """The port exports every name of the JAX package's ``__all__``."""
    assert set(J.__all__) <= set(T.__all__), sorted(set(J.__all__) - set(T.__all__))
    for name in T.__all__:
        assert getattr(T, name) is not None, name


def test_native_result_is_the_whole_result(models, batch, results):
    """``native.native_result``: the C++ oracle's columns with the per-def
    start and end enables, a whole ``RegexResult`` equal to JAX's portable
    scan (dtypes included), whose verdicts the checker confirms."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native oracle)")
    jm, tm = models["regex3"]
    got = native.native_result(tm, *batch)
    _same(got, results[0])
    np.testing.assert_array_equal(T.check_witness_batch(tm.regex_defs, got), got.match_ok)
