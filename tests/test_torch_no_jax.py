"""The PyTorch port never imports JAX.

``tests/conftest.py`` imports jax into the test process itself, so the
check runs the port in a fresh interpreter: import it with its CLI, corpus
utilities and native packers, run a tiny match of each column set, a
direct-emission and an in-scan-pack witness, a run extraction, a tiled
match, the table-driven ``PallasMatcher`` (batch,
segmented and monolithic), the portable scan ``BatchMatcher``, the native
oracle ``match_substrs_native``, a CLI scan and a device-expand
``ScanJob`` on the CPU, the prover's host layer (``expand_witness``,
``check_witness_batch``, ``save_witness`` / ``load_witness``, the hand-off
dump and its C++ verifier, ``gen_circom``, the CLI's ``gen-circom`` and
``handoff``) and the sharded matchers (``DistributedMatcher``,
``SeqShardedMatcher``, ``SpeculativeSeqMatcher`` on a mesh of repeated CPU
devices; ``parallel.launch`` at one process), the serial-scan probes'
plain versions, the table-kernel, the emission and decode and the
marker-stream probe scripts on the CPU (``probes/``: probe_tpu57's D at
64 x 512 and E at 64 x 1024 held against the C++ oracle), and assert that neither JAX, the JAX
package nor ``tools/`` was loaded along the way.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, os, sys, tempfile
import numpy as np
import halo2_regex_tpu_torch as h2r
import halo2_regex_tpu_torch.cli, halo2_regex_tpu_torch.native
import halo2_regex_tpu_torch.utils.io, halo2_regex_tpu_torch.utils.jobs
import halo2_regex_tpu_torch.utils.trace
import halo2_regex_tpu_torch.parallel.launch
import torch
from halo2_regex_tpu_torch.compiler.circom_sim import CircomSim
from halo2_regex_tpu_torch.parallel.seq_parallel import SpeculativeSeqMatcher
from halo2_regex_tpu_torch.witness import handoff

cfg_json = {
    "max_byte_size": 32,
    "parts": [
        {"is_public": False, "regex_def": "id: ", "max_size": 4},
        {"is_public": True, "regex_def": "(0|1|2|3|4|5|6|7|8|9)+", "max_size": 8},
        {"is_public": False, "regex_def": ".", "max_size": 1},
    ],
}
cfg = h2r.DecomposedRegexConfig.from_json(cfg_json)
model = h2r.CompiledRegexModel.from_decomposed(cfg)
m = h2r.BitplaneMatcher(model, columns="witness", device="cpu")
out = m.match_one(b"id: 1234.")
assert bool(out["match_ok"]), out
ids = out["all_substr_ids"]
assert bytes(out["masked_characters"][ids > 0]) == b"1234", out
chars = np.zeros((2, 32), np.uint8)
chars[0, :9] = bytearray(b"id: 1234.")
lengths = np.array([9, 0], np.int32)
res = h2r.BitplaneMatcher(model, device="cpu")(chars, lengths)
runs = h2r.extract_runs(res.all_substr_ids, res.masked_characters, max_len=8)
assert h2r.runs_to_python(runs, 0) == [(4, "1234", 1)], runs
verdict = h2r.BitplaneMatcher(model, columns="match", device="cpu")(chars, lengths)
assert verdict["match_ok"].tolist() == [True, False], verdict
for grid_mode in ("batch", "segmented"):
    table = h2r.PallasMatcher(model, grid_mode=grid_mode, device="cpu")(chars, lengths)
    assert table.match_ok.tolist() == [True, False], table
    assert table.all_substr_ids.tolist() == res.all_substr_ids.long().tolist()
mono = h2r.PallasMatcher(model, mode="monolithic", device="cpu")
assert mono.mode == "monolithic"
assert mono(chars, lengths).all_substr_ids.tolist() == res.all_substr_ids.long().tolist()
for kw in (dict(emit="direct"), dict(fuse_pack=True)):
    v = h2r.BitplaneMatcher(model, columns="witness", device="cpu", **kw)(chars, lengths)
    assert v["match_ok"].tolist() == [True, False], (kw, v)
    assert bytes(v["masked_characters"][0][v["all_substr_ids"][0] > 0]) == b"1234", (kw, v)
portable = h2r.BatchMatcher(model, device="cpu")(chars, lengths)
assert portable.all_substr_ids.tolist() == res.all_substr_ids.tolist()
if halo2_regex_tpu_torch.native.available():
    host = halo2_regex_tpu_torch.native.match_substrs_native(model, chars, lengths)
    assert host["mask"].tolist() == res.mask.tolist(), host
tl = h2r.BitplaneMatcher(model, columns="match", input_layout="tiled", device="cpu")
assert tl(h2r.tile_corpus(chars, tl.L_pad), lengths)["match_ok"].tolist() == [True, False]
with tempfile.TemporaryDirectory() as d:
    model.save(os.path.join(d, "m.npz"))
    with open(os.path.join(d, "c.txt"), "wb") as f:
        f.write(b"id: 1234.\nnope\n")
    assert halo2_regex_tpu_torch.cli.main(
        ["scan", "--model", os.path.join(d, "m.npz"), "--device", "cpu",
         "--input-layout", "tiled", os.path.join(d, "c.txt")]) == 0
    job = h2r.ScanJob(h2r.BatchMatcher(model, device="cpu"), [os.path.join(d, "c.txt")],
                      device_expand=True).run()
    assert (job.strings, job.matched) == (2, 1), job
w = h2r.BitplaneMatcher(model, columns="witness", device="cpu")(chars, lengths)
full = h2r.expand_witness(model, w, chars)
assert h2r.check_witness_batch(model.regex_defs, full).tolist() == [True, False]
text = handoff.dump_prover_rows(model.regex_defs, full.map(lambda a: a[0]))
assert handoff.verify_handoff(handoff.load_prover_rows(text)) == []
circom = h2r.gen_circom(cfg, None, "T")
assert CircomSim(circom, b"id: 1234.", 32).out == 1
mesh = h2r.make_mesh(data=2, seq=2, devices=[torch.device("cpu")] * 4)
dm, stats = h2r.DistributedMatcher(model, mesh)(chars, lengths)
assert dm.match_ok.tolist() == [True, False] and int(stats["n_matched"]) == 1
seq = h2r.SeqShardedMatcher(model, mesh).match(chars, lengths)
assert seq.all_substr_ids.tolist() == res.all_substr_ids.tolist()
spec = SpeculativeSeqMatcher(model, mesh, per_shard="pallas")(chars, lengths)
assert spec["all_substr_ids"].tolist() == res.all_substr_ids.tolist()
with tempfile.TemporaryDirectory() as d:
    h2r.save_witness(os.path.join(d, "w.npz"), model.regex_defs, full)
    assert h2r.load_witness(os.path.join(d, "w.npz"))[1].mask.tolist() == full.mask.tolist()
    with open(os.path.join(d, "h.txt"), "w") as f:
        f.write(text)
    if halo2_regex_tpu_torch.native.available():
        assert halo2_regex_tpu_torch.native.handoff_check(os.path.join(d, "h.txt")).returncode == 0
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump(cfg_json, f)
    model.save(os.path.join(d, "m.npz"))
    assert halo2_regex_tpu_torch.cli.main(
        ["gen-circom", "--decomposed-regex-path", os.path.join(d, "cfg.json"),
         "--circom-file-path", os.path.join(d, "t.circom"), "--template-name", "T"]) == 0
    assert halo2_regex_tpu_torch.cli.main(
        ["handoff", "--model", os.path.join(d, "m.npz"), "--output",
         os.path.join(d, "h2.txt"), "--device", "cpu", "id: 1234."]) == 0
    with open(os.path.join(d, "c.txt"), "wb") as f:
        f.write(b"id: 1234.\nnope\n")
    assert halo2_regex_tpu_torch.parallel.launch.main(
        ["--model", os.path.join(d, "m.npz"), "--corpus", os.path.join(d, "c.txt"),
         "--device", "cpu", "--batch-per-host", "4"]) == 0
from halo2_regex_tpu_torch.probes import probe_tpu9, probe_tpu20, probe_tpu56
x, classes, tk = probe_tpu9.inputs(64, 16)
for slab in (1, 8):
    assert torch.equal(probe_tpu9.loop_floor(x, slab), torch.cumsum(x, 0, dtype=torch.int32))
assert [tuple(o.shape) for o in probe_tpu9.slab_scan(tk, classes, x)] == [(64, 16)] * 4
cls, st0 = probe_tpu20.inputs(256, 1)
assert bool(probe_tpu20.bitop_scan(cls, st0, 96).any())
assert not bool(probe_tpu20.bitop_scan(cls, torch.zeros_like(st0), 96).any())
assert int((probe_tpu56.chains(probe_tpu56.inputs(1), 64) != 0).sum()) == 123
from halo2_regex_tpu_torch.probes import (probe_tpu, probe_tpu2, probe_tpu3, probe_tpu17,
                                          probe_tpu18, probe_tpu47, probe_tpu48, probe_tpu64,
                                          probe_tpu68)
for mod in (probe_tpu, probe_tpu2, probe_tpu3, probe_tpu17, probe_tpu18, probe_tpu47,
            probe_tpu48, probe_tpu64, probe_tpu68):
    assert mod.main(["--device", "cpu"]) == 0, mod.__name__
from halo2_regex_tpu_torch.probes import (probe_tpu6, probe_tpu7, probe_tpu21, probe_tpu28,
                                          probe_tpu30, probe_tpu31, probe_tpu32, probe_tpu67)
for mod in (probe_tpu6, probe_tpu7, probe_tpu21, probe_tpu28, probe_tpu30, probe_tpu31,
            probe_tpu32, probe_tpu67):
    assert mod.main(["--device", "cpu"]) == 0, mod.__name__
assert probe_tpu20.main(["--device", "cpu", "--sections", "ADE"]) == 0
from halo2_regex_tpu_torch.probes import probe_tpu57, probe_tpu61
assert probe_tpu57.main(["--device", "cpu"]) == 0  # B-C vs re, D and E vs the C++ oracle
assert probe_tpu61.main(["--device", "cpu"]) == 0
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "halo2_regex_tpu", "tools"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout
