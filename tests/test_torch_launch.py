"""The port's multi-process corpus-scan launcher: two real processes on the
CPU, joined by ``torch.distributed`` over gloo.

Spawns two ``python -m halo2_regex_tpu_torch.parallel.launch --device cpu``
processes on the uneven corpus shards of tests/test_launch_multiprocess.py
(one file each, round-robin on the sorted paths, different batch counts:
the exhausted process feeds empty batches until the all-reduced valid
count is 0).  Process 0's totals must equal the JAX package's oracle
counts over the same lines (``ops.reference.match_substrs`` line by line).
The processes get a time limit of their own and are killed past it.
"""

import json
import os
import socket
import subprocess
import sys

from halo2_regex_tpu.ops import reference as jref

import halo2_regex_tpu_torch as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_launch(tmp_path):
    L = 64
    model = T.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    model_path = tmp_path / "model.npz"
    model.save(model_path)
    lines0 = [b"from:alice@gmail.com\r", b"junk", b"from:bob@x.yz\r"] * 4
    lines1 = [b"from:carol@sub.domain-x.org\r", b"nope"] * 4
    (tmp_path / "shard-0.txt").write_bytes(b"\n".join(lines0) + b"\n")
    (tmp_path / "shard-1.txt").write_bytes(b"\n".join(lines1) + b"\n")

    # the JAX package's oracle over the same lines (--keep-newline: each
    # line keeps its \n, which the from: accept state needs)
    want = {"n_matched": 0, "bytes_scanned": 0, "n_dead": 0, "strings": 0}
    for line in lines0 + lines1:
        s = line + b"\n"
        res = jref.match_substrs(model.regex_defs, s, L)
        want["n_matched"] += int(bool(res.match_ok))
        want["n_dead"] += int(bool(res.has_dead.any()))
        want["bytes_scanned"] += len(s)
        want["strings"] += 1
    assert want["n_matched"] == 8 + 4

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "halo2_regex_tpu_torch.parallel.launch",
               "--model", str(model_path), "--corpus", str(tmp_path / "shard-*.txt"),
               "--batch-per-host", "8", "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", "2", "--process-id", str(pid), "--keep-newline",
               "--device", "cpu"]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, cwd=str(tmp_path)))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LIMIT_S)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _out, err in outs:
        assert rc == 0, f"launch process failed rc={rc}\n{err[-2000:]}"
    stats = [json.loads(ln) for ln in outs[0][1].splitlines() if ln.startswith("{")]
    assert stats, f"no stats line in stdout: {outs[0][1]!r}"
    got = stats[-1]
    assert {k: got[k] for k in want} == want, got
    assert got["bytes_per_sec"] > 0
    assert not any(ln.startswith("{") for ln in outs[1][1].splitlines())
