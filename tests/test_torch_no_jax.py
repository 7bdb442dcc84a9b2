"""The PyTorch port never imports JAX.

``tests/conftest.py`` imports jax into the test process itself, so the
check runs the port in a fresh interpreter: import it with its CLI, corpus
utilities and native packers, run a tiny match of each column set, a
direct-emission and an in-scan-pack witness, a run extraction, a tiled
match, the table-driven ``PallasMatcher`` (batch,
segmented and monolithic), the portable scan ``BatchMatcher``, the native
oracle ``match_substrs_native``, a CLI scan and a device-expand
``ScanJob`` on the CPU, and assert that neither JAX nor the JAX package
was loaded along the way.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, sys, tempfile
import numpy as np
import halo2_regex_tpu_torch as h2r
import halo2_regex_tpu_torch.cli, halo2_regex_tpu_torch.native
import halo2_regex_tpu_torch.utils.io, halo2_regex_tpu_torch.utils.jobs
import halo2_regex_tpu_torch.utils.trace

cfg = h2r.DecomposedRegexConfig.from_json({
    "max_byte_size": 32,
    "parts": [
        {"is_public": False, "regex_def": "id: ", "max_size": 4},
        {"is_public": True, "regex_def": "(0|1|2|3|4|5|6|7|8|9)+", "max_size": 8},
        {"is_public": False, "regex_def": ".", "max_size": 1},
    ],
})
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
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "halo2_regex_tpu"))
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
