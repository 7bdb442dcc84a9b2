"""The PyTorch port's compiler and models against the JAX package's.

The port carries jax-free copies of the regex compiler, the model packing
and the circuit synthesis (``halo2_regex_tpu_torch``); these tests hold
each copy to the original: the same configs give equal tables and
identical synthesized programs, and a model saved by the JAX package
loads unchanged into the port.  Integer arrays, tolerance 0.
"""

import numpy as np
import pytest
import torch

import halo2_regex_tpu as J
from halo2_regex_tpu.compiler import bitslice as jbs
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import _substr_pairs as j_substr_pairs

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.compiler import bitslice as tbs
from halo2_regex_tpu_torch.ops.bitplane import _substr_pairs as t_substr_pairs

from fixtures import CONFIGS

MAX_LEN = 64
NAMES = ["regex1", "regex2", "regex3", "from"]
ARRAYS = [
    "transition", "substr_id_table", "first_states", "accepted_states",
    "dummy_states", "dead_states", "substr_offsets", "is_start_table",
    "is_end_table", "accept_mask",
]


def _build(pkg, zoo, name):
    if name == "from":
        return zoo.email_headers_model(max_chars_size=MAX_LEN, headers=("from",))
    return pkg.CompiledRegexModel.from_decomposed(
        pkg.DecomposedRegexConfig.from_json(CONFIGS[name]), max_chars_size=MAX_LEN
    )


@pytest.fixture(scope="module")
def models():
    return {
        name: (_build(J, jzoo, name), _build(T, T.zoo, name)) for name in NAMES
    }


def assert_models_equal(jm, tm):
    assert (tm.max_chars_size, tm.s_pad) == (jm.max_chars_size, jm.s_pad)
    for name in ARRAYS:
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for dj, dt in zip(jm.regex_defs, tm.regex_defs):
        assert dj.allstr.to_text() == dt.allstr.to_text()
        assert [s.to_text() for s in dj.substrs] == [s.to_text() for s in dt.substrs]
        assert dj.accept_states == dt.accept_states


@pytest.mark.parametrize("name", NAMES)
def test_compiled_tables_equal(models, name):
    jm, tm = models[name]
    assert_models_equal(jm, tm)


# the synthesis options of each class stage: binary (the main path; its
# cases keep their plain model ids), one-hot class planes, and the class
# BDD folded into the step circuit (the class stage off)
STAGES = {"binary": dict(fold_class=False, class_encoding="binary"),
          "onehot": dict(fold_class=False, class_encoding="onehot"),
          "fold_class": dict(fold_class=True, class_encoding="onehot")}


@pytest.mark.parametrize("name,stage", [(n, s) for s in STAGES for n in NAMES],
                         ids=[n if s == "binary" else f"{n}-{s}" for s in STAGES for n in NAMES])
def test_synthesized_programs_identical(models, name, stage):
    """Under each class stage the class, step and tag programs are
    instruction-for-instruction the same."""
    jm, tm = models[name]
    idb = max(1, int(jm.total_substrs).bit_length())
    for d in range(jm.n_defs):
        kw = dict(idb=idb, **STAGES[stage])
        cj = jbs.synthesize_def(
            jm.transition[d], int(jm.first_states[d]), int(jm.dead_states[d]),
            j_substr_pairs(jm, d), **kw,
        )
        ct = tbs.synthesize_def(
            tm.transition[d], int(tm.first_states[d]), int(tm.dead_states[d]),
            t_substr_pairs(tm, d), **kw,
        )
        assert (ct.k, ct.sb, ct.live_states) == (cj.k, cj.sb, cj.live_states)
        np.testing.assert_array_equal(ct.class_of, cj.class_of)
        for prog in ("class_prog", "step_prog", "tag_prog"):
            pj, pt = getattr(cj, prog), getattr(ct, prog)
            assert pt.instrs == pj.instrs, (d, prog)
            assert (pt.inputs, pt.outputs, pt.n_regs) == (
                pj.inputs, pj.outputs, pj.n_regs
            ), (d, prog)


def test_load_jax_saved_model(models, tmp_path):
    """A .npz written by the JAX package's ``save`` loads unchanged, both
    through ``load`` and through ``from_jax_arrays``."""
    jm, _ = models["regex3"]
    path = tmp_path / "regex3.npz"
    jm.save(path)
    assert_models_equal(jm, T.CompiledRegexModel.load(path))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    assert_models_equal(jm, T.CompiledRegexModel.from_jax_arrays(arrays))


def test_from_jax_arrays_two_defs_multi_accept(tmp_path):
    """Multi-def, multi-accept tables survive the hand-over."""
    cfgs = [J.DecomposedRegexConfig.from_json(CONFIGS[c]) for c in ("regex1", "regex2")]
    jm = J.CompiledRegexModel.from_decomposed(cfgs, max_chars_size=MAX_LEN,
                                              multi_accept=True)
    path = tmp_path / "m12.npz"
    jm.save(path)
    with np.load(path) as z:
        tm = T.CompiledRegexModel.from_jax_arrays({k: z[k] for k in z.files})
    assert_models_equal(jm, tm)


def test_program_run_returns_torch(models):
    """The port's ``Program.run`` builds its constants as torch tensors:
    torch operands give torch outputs equal to the numpy run (the JAX
    package's copy returns numpy arrays here)."""
    jm, tm = models["from"]
    idb = max(1, int(tm.total_substrs).bit_length())
    c = tbs.synthesize_def(
        tm.transition[0], int(tm.first_states[0]), int(tm.dead_states[0]),
        t_substr_pairs(tm, 0), idb=idb, fold_class=False, class_encoding="binary",
    )
    assert any(op == "const0" for op, *_ in c.step_prog.instrs)
    rng = np.random.default_rng(3)
    names = list(c.step_prog.inputs)
    env_np = {
        n: rng.integers(-2**31, 2**31, size=(4, 128), dtype=np.int64).astype(np.int32)
        for n in names
    }
    out_np = c.step_prog.run(env_np)
    out_t = c.step_prog.run({n: torch.from_numpy(v) for n, v in env_np.items()})
    for n, v in out_np.items():
        assert isinstance(out_t[n], torch.Tensor), n
        assert out_t[n].dtype == torch.int32, n
        np.testing.assert_array_equal(out_t[n].numpy(), v, err_msg=n)
    bools = c.step_prog.run({n: torch.from_numpy(v > 0) for n, v in env_np.items()})
    for n, v in c.step_prog.run({n: v > 0 for n, v in env_np.items()}).items():
        assert bools[n].dtype == torch.bool, n
        np.testing.assert_array_equal(bools[n].numpy(), v, err_msg=n)


def test_zoo_and_reference_match_jax(models):
    """The port's numpy oracle gives the JAX package's oracle results."""
    from halo2_regex_tpu.ops.reference import match_substrs as jmatch

    from halo2_regex_tpu_torch.ops.reference import match_substrs as tmatch

    jm, tm = models["from"]
    for s in (b"from:alice@gmail.com\r\n", b"xy\r\nfrom:bob<bob@x.yz>\r\n", b"", b"nope"):
        rj = jmatch(jm.regex_defs, s, MAX_LEN)
        rt = tmatch(tm.regex_defs, s, MAX_LEN)
        for f in rj.field_names():
            np.testing.assert_array_equal(
                np.asarray(getattr(rt, f)), np.asarray(getattr(rj, f)), err_msg=f
            )
