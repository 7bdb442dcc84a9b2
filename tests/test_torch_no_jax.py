"""The PyTorch port never imports JAX.

``tests/conftest.py`` imports jax into the test process itself, so the
check runs the port in a fresh interpreter: import it, run a tiny match
of each column set, a run extraction and the table-driven ``PallasMatcher``
(batch and segmented) on the CPU, and assert that neither JAX nor the JAX
package was loaded along the way.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np
import halo2_regex_tpu_torch as h2r

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
