"""The port's sharded matchers against the JAX package's on the CPU.

JAX runs on the 8 virtual CPU devices tests/conftest.py sets up; the port
on a mesh of eight repeated CPU devices (``[torch.device("cpu")] * 8``),
its counterpart.  For each mesh shape 8 x 1, 4 x 2 and 2 x 4, the same
inputs go through ``DistributedMatcher`` (both backends, stats included),
``SeqShardedMatcher`` (its dict and its ``match`` view) and
``SpeculativeSeqMatcher`` (both ``per_shard``, ``spec_rounds`` included) of
both packages; every column must be equal, dtypes included (tolerance 0:
integer outputs).  JAX's Pallas kernels run in interpret mode, the port's
plain versions.  Also: ``make_mesh``'s arithmetic and errors, the
adversarial random table of tests/test_spec_seq.py (speculation needs every
round), and the port's sharded results against its unsharded
``BatchMatcher``.
"""

import jax
import numpy as np
import pytest
import torch

from halo2_regex_tpu.models.compiled import CompiledRegexModel as JModel
from halo2_regex_tpu.models.defs import AllstrRegexDef as JAllstr
from halo2_regex_tpu.models.defs import RegexDefs as JDefs
from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig as JConfig
from halo2_regex_tpu.parallel import mesh as jmesh
from halo2_regex_tpu.parallel.data_parallel import DistributedMatcher as JDistributed
from halo2_regex_tpu.parallel.seq_parallel import SeqShardedMatcher as JSeq
from halo2_regex_tpu.parallel.seq_parallel import SpeculativeSeqMatcher as JSpec

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.models.defs import AllstrRegexDef, RegexDefs
from halo2_regex_tpu_torch.parallel import mesh as tmesh
from halo2_regex_tpu_torch.parallel.seq_parallel import SpeculativeSeqMatcher

from fixtures import CONFIGS

L = 128
STRINGS = [
    b"from:alice@gmail.com\r\n",
    b"",
    b"dummy\r\nfrom:alice<alice@gmail.com>\r\n",
    b"from:alice<alicegmail.com>\r\n",
    b"x" * (L - 1),
    b"from:a@b.cd\r\n" + b"y" * 90,
    b"\r\n" * 40,
    b"from:x.y@z.ww\r\n",
] * 2  # 16 rows: two a table tile on every shard of the 8 x 1 mesh
SHAPES = [(8, 1), (4, 2), (2, 4)]
CPU8 = [torch.device("cpu")] * 8
# the Pallas matchers' batch tile; JAX's interpret-mode kernels need every
# shard to hold whole tiles
PALLAS_KW = dict(batch_tile=2)


@pytest.fixture(scope="module")
def models():
    cfg = CONFIGS["regex3"]
    return (JModel.from_decomposed(JConfig.from_json(cfg), max_chars_size=L),
            T.CompiledRegexModel.from_decomposed(T.DecomposedRegexConfig.from_json(cfg),
                                                 max_chars_size=L))


@pytest.fixture(scope="module")
def batch():
    return T.pack_batch(STRINGS, L)


def _meshes(data, seq):
    return (jmesh.make_mesh(data=data, seq=seq, devices=jax.devices()[:8]),
            tmesh.make_mesh(data=data, seq=seq, devices=CPU8))


def _equal(got, want):
    """Every column of the port's output equals JAX's, dtype and shape
    included."""
    got = got if isinstance(got, dict) else vars(got)
    want = want if isinstance(want, dict) else vars(want)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_make_mesh_arithmetic_and_errors():
    for kw in (dict(), dict(seq=2), dict(data=2, seq=4), dict(seq=8)):
        jm = jmesh.make_mesh(devices=jax.devices()[:8], **kw)
        tm = tmesh.make_mesh(devices=CPU8, **kw)
        assert tm.shape == dict(jm.shape)
        assert tm.axis_names == tuple(jm.axis_names) == (tmesh.DATA_AXIS, tmesh.SEQ_AXIS)
        assert all(d == torch.device("cpu") for d in tm.devices.flat)
        assert jmesh.shard_batch_size(16, jm) == tmesh.shard_batch_size(16, tm)
    for kw in (dict(seq=3), dict(data=3, seq=2), dict(data=16)):
        with pytest.raises(ValueError) as je:
            jmesh.make_mesh(devices=jax.devices()[:8], **kw)
        with pytest.raises(ValueError) as te:
            tmesh.make_mesh(devices=CPU8, **kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jmesh.shard_batch_size(12, jmesh.make_mesh(devices=jax.devices()[:8]))
    with pytest.raises(ValueError) as te:
        tmesh.shard_batch_size(12, tmesh.make_mesh(devices=CPU8))
    assert str(te.value) == str(je.value)


def test_make_mesh_default_is_the_cards():
    """Without ``devices`` the mesh is every visible CUDA device once; where
    there is none it raises rather than building a CPU mesh."""
    if torch.cuda.is_available():
        m = tmesh.make_mesh()
        assert [d.type for d in m.devices.flat] == ["cuda"] * torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.DistributedMatcher(T.zoo.email_headers_model(max_chars_size=64))


def test_initialize_distributed_one_process_is_a_no_op():
    tmesh.initialize_distributed()
    tmesh.initialize_distributed(num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.initialize_distributed(num_processes=2, process_id=0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_distributed_matcher_equals_jax(models, batch, backend, shape):
    jm, tm = models
    jme, tme = _meshes(*shape)
    jkw = dict(pallas_kwargs=dict(interpret=True, **PALLAS_KW)) if backend == "pallas" else {}
    tkw = dict(pallas_kwargs=PALLAS_KW) if backend == "pallas" else {}
    want, want_stats = JDistributed(jm, jme, backend=backend, **jkw)(*batch)
    got, stats = T.DistributedMatcher(tm, tme, backend=backend, **tkw)(*batch)
    _equal(got, want)
    _equal(stats, want_stats)
    assert int(stats["n_matched"]) > 0 and int(stats["extracted_bytes"]) > 0
    _equal(got, vars(T.BatchMatcher(tm, device="cpu")(*batch)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_seq_sharded_equals_jax(models, batch, shape):
    jm, tm = models
    jme, tme = _meshes(*shape)
    jsm, tsm = JSeq(jm, jme), T.SeqShardedMatcher(tm, tme)
    _equal(tsm(*batch), jsm(*batch))
    res = tsm.match(*batch)
    _equal(res, jsm.match(*batch))
    _equal(res, T.BatchMatcher(tm, device="cpu")(*batch))


@pytest.mark.parametrize("per_shard", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_speculative_equals_jax(models, batch, per_shard, shape):
    jm, tm = models
    jme, tme = _meshes(*shape)
    if per_shard == "pallas":
        jkw, tkw = dict(pallas_kwargs=dict(interpret=True, **PALLAS_KW)), dict(pallas_kwargs=PALLAS_KW)
    else:
        jkw = tkw = {}
    want = JSpec(jm, jme, per_shard=per_shard, **jkw)(*batch)
    spec = SpeculativeSeqMatcher(tm, tme, per_shard=per_shard, **tkw)
    got = spec(*batch)
    _equal(got, want)  # spec_rounds included
    assert int(got["spec_rounds"][0]) == (1 if shape[1] == 1 else 2)
    _equal(spec.match(*batch), T.SeqShardedMatcher(tm, tme).match(*batch))


def _random_table(allstr_cls, defs_cls, model_cls, S=64, Lr=64):
    """tests/test_spec_seq.py:76's dense random table, built from the same
    default_rng(3) draws, in one package's classes."""
    rng = np.random.default_rng(3)
    allstr = allstr_cls(first_state_val=0, accepted_state_val=1, largest_state_val=S - 1)
    line = 3
    for c in range(97, 107):
        for s in range(S):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, S)))
            line += 1
    model = model_cls.from_defs([defs_cls(allstr=allstr, substrs=[])], max_chars_size=Lr)
    return model, rng


@pytest.mark.parametrize("per_shard", ["xla", "pallas"])
def test_speculative_adversarial_random_table(per_shard):
    """A random dense table never resynchronizes: speculation takes more
    than one round, as many as JAX's, and stays exact."""
    jm, rng = _random_table(JAllstr, JDefs, JModel)
    tm, _ = _random_table(AllstrRegexDef, RegexDefs, T.CompiledRegexModel)
    chars = rng.integers(97, 107, size=(4, 64)).astype(np.uint8)
    lengths = np.array([64, 64 - 7, 3, 0], np.int32)
    jme, tme = _meshes(1, 8)
    kw = dict(pallas_kwargs=dict(batch_tile=4)) if per_shard == "pallas" else {}
    want = JSeq(jm, jme)(chars, lengths)
    got = SpeculativeSeqMatcher(tm, tme, per_shard=per_shard, **kw)(chars, lengths)
    rounds = JSpec(jm, jme, per_shard="xla")(chars, lengths)["spec_rounds"]
    _equal({k: got[k] for k in want}, want)
    _equal({"spec_rounds": got["spec_rounds"]}, {"spec_rounds": rounds})
    assert int(got["spec_rounds"][0]) >= 2
    _equal(T.SeqShardedMatcher(tm, tme)(chars, lengths), want)


def test_seq_sharded_long_input():
    """The long-input shape (configs[3]-style, scaled down for the CPU): a
    4096-byte string over four shards, against JAX's exact scheme."""
    Ll = 4096
    cfg = CONFIGS["regex3"]
    jm = JModel.from_decomposed(JConfig.from_json(cfg), max_chars_size=Ll)
    tm = T.CompiledRegexModel.from_decomposed(T.DecomposedRegexConfig.from_json(cfg),
                                              max_chars_size=Ll)
    s = b"x" * 3000 + b"\r\nfrom:alice@gmail.com\r\n"
    chars, lengths = T.pack_batch([s, s[:100]], Ll)
    jme, tme = _meshes(2, 4)
    got = T.SeqShardedMatcher(tm, tme)(chars, lengths)
    _equal(got, JSeq(jm, jme)(chars, lengths))
    assert got["match_ok"].tolist() == [True, False]
