"""The PyTorch port's corpus-scan entry point against the JAX package.

Mirrors tests/test_cli.py, tests/test_handoff.py's CLI test and
tests/test_io.py: the port's CLI prints the JAX CLI's stdout for
``gen-halo2-texts``, ``gen-circom``, ``compile``, ``match`` (each
backend), ``handoff``, ``explain`` and ``scan`` in both input layouts
(less the wall-clock fields), with the same exit codes and files; the corpus loader and ``ScanJob`` (checkpoint and
resume, oversize lines, prefetch parity and errors, the device-expand
form); ``Counters`` on torch tensors; and the ``best_matcher`` ladder.
Every matcher here runs on the CPU (``--device cpu`` / ``device="cpu"``);
the JAX CLI runs on the CPU too.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from halo2_regex_tpu.cli import main as jax_main

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch import native
from halo2_regex_tpu_torch.cli import main
from halo2_regex_tpu_torch.ops import best_matcher
from halo2_regex_tpu_torch.utils.io import CorpusLoader, batch_iterator, pack_batch, pack_lines
from halo2_regex_tpu_torch.utils.jobs import ScanJob
from halo2_regex_tpu_torch.utils.trace import Counters
from halo2_regex_tpu_torch.witness.handoff import load_prover_rows, verify_handoff

from fixtures import CONFIGS, EXPECTED_SHA256, sha256_text

MATCH_ARGS = ["email was meant for @y. Also for x.", "email was meant for @@"]
TIMING = ("wall_seconds", "bytes_per_sec")


def run(fn, argv):
    """(exit code, stdout) of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.fixture()
def config_path(tmp_path):
    p = tmp_path / "regex1.json"
    p.write_text(json.dumps(CONFIGS["regex1"]))
    return p


@pytest.fixture()
def model_paths(tmp_path, config_path):
    """The regex1 model at L=64 compiled by each CLI: (port's, JAX's)."""
    paths = tmp_path / "t.npz", tmp_path / "j.npz"
    for fn, p in zip((main, jax_main), paths):
        rc, _ = run(fn, ["compile", str(config_path), "--max-chars-size", "64", "-o", str(p)])
        assert rc == 0
    return paths


def test_gen_halo2_texts(tmp_path, config_path):
    outs = []
    for fn, d in ((main, "t"), (jax_main, "j")):
        allstr = tmp_path / d / "allstr.txt"
        allstr.parent.mkdir()
        rc, out = run(fn, [
            "gen-halo2-texts",
            "--decomposed-regex-path", str(config_path),
            "--allstr-file-path", str(allstr),
            "--substrs-dir-path", str(tmp_path / d / "subs"),
        ])
        assert rc == 0
        assert sha256_text(allstr.read_text()) == EXPECTED_SHA256["regex1_allstr"]
        assert sha256_text((tmp_path / d / "subs" / "substr0.txt").read_text()) == (
            EXPECTED_SHA256["substr1"])
        outs.append(out.replace(f"/{d}/", "/_/"))
    assert outs[0] == outs[1]


def test_compile_and_match(tmp_path, config_path):
    outs = [run(fn, ["compile", str(config_path), "--max-chars-size", "64", "-o",
                     str(tmp_path / "m.npz")]) for fn in (main, jax_main)]
    assert outs[0] == outs[1] and outs[0][0] == 0
    rc, out = run(main, ["match", "--model", str(tmp_path / "m.npz"), "--device", "cpu",
                         *MATCH_ARGS])
    assert rc == 0
    lines = [json.loads(ln) for ln in out.strip().splitlines()]
    assert lines[0]["status"] == "MATCH"
    assert lines[0]["substrings"][0] == {"offset": 21, "text": "y", "substr_id": 1}
    assert lines[1]["status"] == "NO-MATCH"
    assert (rc, out) == run(jax_main, ["match", "--model", str(tmp_path / "m.npz"), *MATCH_ARGS])


@pytest.mark.parametrize("backend", ["bitplane", "pallas", "xla"])
def test_match_backends_print_the_same(model_paths, backend):
    t, j = model_paths
    got = run(main, ["match", "--model", str(t), "--device", "cpu", "--backend", backend,
                     *MATCH_ARGS])
    assert got == run(jax_main, ["match", "--model", str(j), *MATCH_ARGS])


def test_match_strict_exit_code(model_paths):
    t, j = model_paths
    args = ["--strict", "bad input"]
    got = run(main, ["match", "--model", str(t), "--device", "cpu", *args])
    assert got[0] == 1
    assert got == run(jax_main, ["match", "--model", str(j), *args])


def test_match_lines_file(tmp_path, model_paths):
    t, j = model_paths
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("email was meant for @ab. Also for cd.\nnope\n")
    args = ["--input-file", str(corpus), "--lines"]
    rc, out = run(main, ["match", "--model", str(t), "--device", "cpu", *args])
    assert rc == 0
    lines = [json.loads(ln) for ln in out.strip().splitlines()]
    assert [ln["status"] for ln in lines] == ["MATCH", "NO-MATCH"]
    assert (rc, out) == run(jax_main, ["match", "--model", str(j), *args])


def test_explain(model_paths):
    t, j = model_paths
    rc, out = run(main, ["explain", "--model", str(t), MATCH_ARGS[0]])
    assert rc == 0
    assert "match_ok: True" in out and "extracted: [(21, 'y', 1)" in out
    assert (rc, out) == run(jax_main, ["explain", "--model", str(j), MATCH_ARGS[0]])


def test_gen_circom_matches_jax(tmp_path, config_path):
    outs = []
    for fn, d in ((main, "t"), (jax_main, "j")):
        path = tmp_path / f"{d}.circom"
        rc, out = run(fn, ["gen-circom", "--decomposed-regex-path", str(config_path),
                           "--circom-file-path", str(path), "--template-name", "Test1Regex"])
        assert rc == 0
        outs.append((out.replace(f"{d}.circom", "_.circom"), path.read_text()))
    assert outs[0] == outs[1]
    assert "template Test1Regex(msg_bytes)" in outs[0][1]


@pytest.mark.parametrize("args", [["email was meant for @y."], ["nope"],
                                  ["--allow-nonmatch", "nope"]],
                         ids=["match", "refused", "allow_nonmatch"])
def test_handoff_matches_jax(tmp_path, model_paths, args):
    """Both CLIs dump the same hand-off file for one model file, with the
    same message and exit code (0, or 1 for a non-matching input without
    --allow-nonmatch, which writes nothing); the port's row comes from its
    matcher on the CPU, JAX's from its numpy oracle."""
    _t, j = model_paths
    got = []
    for fn, d, dev in ((main, "t", ["--device", "cpu"]), (jax_main, "j", [])):
        out_path = tmp_path / f"{d}.txt"
        rc, out = run(fn, ["handoff", "--model", str(j), "--output", str(out_path), *args,
                           *dev])
        got.append((rc, out.replace(f"{d}.txt", "_.txt"),
                    out_path.read_text() if out_path.exists() else None))
    assert got[0] == got[1]
    rc, out, text = got[0]
    if args == ["nope"]:
        assert (rc, text) == (1, None) and "--allow-nonmatch" in out
    else:
        assert rc == 0 and "verification clean" in out
        assert verify_handoff(load_prover_rows(text)) == []


def _counters(out):
    c = json.loads(out.splitlines()[-1])
    return {k: v for k, v in c.items() if k not in TIMING}


@pytest.mark.parametrize("layout", ["bl", "tiled"])
def test_scan_layouts_match_jax(tmp_path, model_paths, layout):
    t, j = model_paths
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join([b"email was meant for @y.", b"nope"] * 9) + b"\n")
    args = ["--batch", "8", "--input-layout", layout, str(corpus)]
    rc, out = run(main, ["scan", "--model", str(t), "--device", "cpu", *args])
    assert rc == 0
    got = _counters(out)
    assert (got["strings"], got["matched"], got["batches"]) == (18, 9, 3)
    jrc, jout = run(jax_main, ["scan", "--model", str(j), *args])
    assert (rc, got) == (jrc, _counters(jout))
    assert set(json.loads(out.splitlines()[-1])) == set(json.loads(jout.splitlines()[-1]))


def test_scan_print_matches_match_jax(tmp_path, model_paths):
    t, j = model_paths
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join([b"email was meant for @yz.", b"nope", b""] * 5) + b"\n")
    args = ["--batch", "4", "--print-matches", str(corpus)]
    rc, out = run(main, ["scan", "--model", str(t), "--device", "cpu", *args])
    jrc, jout = run(jax_main, ["scan", "--model", str(j), *args])
    assert rc == jrc == 0
    assert out.splitlines()[:-1] == jout.splitlines()[:-1]
    assert len(out.splitlines()) == 6
    assert _counters(out) == _counters(jout)


def test_scan_tiled_refusals(tmp_path, model_paths):
    t, _j = model_paths
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"nope\n")
    for extra in (["--print-matches"], ["--backend", "pallas"]):
        rc, _ = run(main, ["scan", "--model", str(t), "--device", "cpu", "--input-layout",
                           "tiled", *extra, str(corpus)])
        assert rc == 2


def test_cli_device_and_backend_refusals(model_paths, monkeypatch):
    """``--backend xla`` (the portable scan) runs and prints what the
    bitplane backend prints; ``--device cuda`` (the default) raises where
    CUDA is absent."""
    t, _j = model_paths
    args = ["match", "--model", str(t), "--device", "cpu", "x", *MATCH_ARGS]
    rc, out = run(main, [*args, "--backend", "xla"])
    assert rc == 0 and len(out.splitlines()) == 3
    assert (rc, out) == run(main, [*args, "--backend", "bitplane"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(main, ["match", "--model", str(t), "x"])


def test_bench(model_paths):
    t, _j = model_paths
    rc, out = run(main, ["bench", "--model", str(t), "--device", "cpu", "--batch", "16",
                         "--iters", "1"])
    rec = json.loads(out)
    assert rc == 0 and rec["platform"] == "cpu" and rec["backend"] == "bitplane"
    assert rec["batch"] == 16 and rec["bytes_per_sec"] > 0


def test_scan_and_bench_on_the_portable_scan(tmp_path, model_paths):
    """``scan`` and ``bench`` with ``--backend xla``: the scan counts what
    the JAX CLI counts."""
    t, j = model_paths
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join([b"email was meant for @y.", b"nope"] * 9) + b"\n")
    args = ["--batch", "8", "--backend", "xla", str(corpus)]
    rc, out = run(main, ["scan", "--model", str(t), "--device", "cpu", *args])
    jrc, jout = run(jax_main, ["scan", "--model", str(j), *args])
    assert rc == jrc == 0 and _counters(out) == _counters(jout)
    rc, out = run(main, ["bench", "--model", str(t), "--device", "cpu", "--batch", "8",
                         "--iters", "1", "--backend", "xla"])
    rec = json.loads(out)
    assert rc == 0 and rec["backend"] == "xla" and rec["bytes_per_sec"] > 0


# ---------------------------------------------------------------------------
# the corpus loader (tests/test_io.py)
# ---------------------------------------------------------------------------


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def test_pack_lines_fallback_matches_native(packer):
    data = b"alpha\nbeta\n\ngamma-longer-than-max\nd"
    chars, lengths, trunc = pack_lines(data, 8)
    assert lengths.tolist() == [5, 4, 0, 8, 1]
    assert trunc == 1
    assert bytes(chars[0][:5]) == b"alpha"
    assert bytes(chars[4][:1]) == b"d"
    assert not chars[2].any() and bytes(chars[3]) == b"gamma-lo"


def test_pack_lines_keep_newline(packer):
    c, l, t = pack_lines(b"ab\ncd\n", 8, keep_newline=True)
    assert l.tolist() == [3, 3]
    assert bytes(c[0][:3]) == b"ab\n" and bytes(c[1][:3]) == b"cd\n"
    c, l, t = pack_lines(b"ab\ncd", 8, keep_newline=True)
    assert l.tolist() == [3, 2] and bytes(c[1][:2]) == b"cd"
    c, l, t = pack_lines(b"abcdefgh\nx\n", 4, keep_newline=True)
    assert t == 1 and l.tolist() == [4, 2]


def test_pack_batch():
    chars, lengths = pack_batch([b"ab", b"", b"xyz"], 4)
    assert lengths.tolist() == [2, 0, 3] and bytes(chars[2]) == b"xyz\x00"
    with pytest.raises(ValueError, match="length 5 > 4"):
        pack_batch([b"abcde"], 4)


def test_batch_iterator_pads_final():
    chars = np.arange(50, dtype=np.uint8).reshape(10, 5)
    lengths = np.full(10, 5, np.int32)
    batches = list(batch_iterator(chars, lengths, 4))
    assert len(batches) == 3
    assert batches[2][0].shape == (4, 5)
    assert batches[2][1].tolist() == [5, 5, 0, 0]
    assert [b[2] for b in batches] == [4, 4, 2]


def _loader_rows(loader):
    rows = []
    for chars, lengths, n_valid in loader:
        rows += [bytes(chars[i][: lengths[i]]) for i in range(n_valid)]
    return rows


def test_corpus_loader_end_to_end(tmp_path):
    lines = [f"line-{i:04d}".encode() for i in range(103)]
    p1, p2 = tmp_path / "a.txt", tmp_path / "b.txt"
    p1.write_bytes(b"\n".join(lines[:50]) + b"\n")
    p2.write_bytes(b"\n".join(lines[50:]) + b"\n")
    assert _loader_rows(CorpusLoader([str(p1), str(p2)], max_len=16, batch_size=16)) == lines


def test_corpus_loader_small_read_chunks(tmp_path):
    """Chunk boundaries mid-line must not lose or split lines."""
    lines = [b"x" * (i % 7 + 1) for i in range(37)]
    p = tmp_path / "c.txt"
    p.write_bytes(b"\n".join(lines) + b"\n")
    assert _loader_rows(CorpusLoader([str(p)], max_len=8, batch_size=8,
                                     read_chunk_bytes=13)) == lines


def test_corpus_loader_keep_newline_chunked(tmp_path):
    p = tmp_path / "x.txt"
    p.write_bytes(b"aaaa\nbb\ncccccc\ndd")
    loader = CorpusLoader([str(p)], max_len=16, batch_size=2, read_chunk_bytes=7,
                          keep_newline=True)
    assert _loader_rows(loader) == [b"aaaa\n", b"bb\n", b"cccccc\n", b"dd"]


def test_corpus_loader_process_sharding(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(f"file{i}\n".encode())
        paths.append(str(p))
    l0 = CorpusLoader(paths, 16, 4, process_index=0, process_count=2)
    l1 = CorpusLoader(paths, 16, 4, process_index=1, process_count=2)
    assert len(l0.paths) == 2 and len(l1.paths) == 2
    assert set(l0.paths) | set(l1.paths) == set(paths)


# ---------------------------------------------------------------------------
# resumable scan jobs (utils/jobs.py)
# ---------------------------------------------------------------------------


def _regex3(L=32):
    return T.CompiledRegexModel.from_decomposed(
        T.DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=L)


def _stable(c):
    return {k: v for k, v in c.snapshot().items() if k != "wall_seconds"}


def test_scan_job_checkpoint_resume(tmp_path):
    """An interrupted-then-resumed job reaches the same totals as one pass
    (at-least-once per chunk; counters and offsets survive the restart)."""
    matcher = T.BitplaneMatcher(_regex3(), columns="match", device="cpu")
    lines = []
    for i in range(97):
        lines.append(b"from:a%d@b.cd\r" % i)
        lines.append(b"nope %d" % i)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join(lines) + b"\n")
    ref = ScanJob(matcher, [str(corpus)], batch_size=16, keep_newline=True).run()
    assert (ref.strings, ref.matched) == (194, 97)

    ckpt = tmp_path / "job.json"
    calls = {"n": 0}

    class Stop(Exception):
        pass

    def bomb(res, chars, lengths, n_valid):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Stop()

    job = ScanJob(matcher, [str(corpus)], checkpoint_path=str(ckpt), batch_size=16,
                  chunk_bytes=256, on_batch=bomb, keep_newline=True)
    with pytest.raises(Stop):
        job.run()
    state = json.loads(ckpt.read_text())
    assert state["offset"] > 0 or state["file_idx"] > 0
    out = ScanJob(matcher, [str(corpus)], checkpoint_path=str(ckpt), batch_size=16,
                  chunk_bytes=256, keep_newline=True).run()
    # at-least-once: only whole re-done chunks can add to the reference
    assert out.matched >= ref.matched and out.strings >= ref.strings
    assert out.matched * ref.strings == ref.matched * out.strings


def test_scan_job_oversize_line_not_split(tmp_path):
    """A line longer than chunk_bytes is one truncated row, not several
    fragments (a fragment could spuriously match)."""
    matcher = T.BitplaneMatcher(_regex3(), columns="match", device="cpu")
    big = b"x" * 250 + b"from:a@b.cd\r"
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join([b"from:ok@b.cd\r", big, b"nope"]) + b"\n")
    job = ScanJob(matcher, [str(corpus)], batch_size=8, chunk_bytes=64, keep_newline=True)
    out = job.run()
    assert (out.strings, out.matched, job.n_truncated) == (3, 1, 1)
    ref = ScanJob(matcher, [str(corpus)], batch_size=8, keep_newline=True).run()
    assert (out.strings, out.matched) == (ref.strings, ref.matched)


def test_scan_job_prefetch_parity_and_errors(tmp_path):
    matcher = T.BitplaneMatcher(_regex3(), columns="match", device="cpu")
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"from:a@b.cd\r\nnope\nfrom:x@y.zw\r\n")
    a = ScanJob(matcher, [str(corpus)], batch_size=4, prefetch=2, keep_newline=True).run()
    b = ScanJob(matcher, [str(corpus)], batch_size=4, prefetch=0, keep_newline=True).run()
    assert _stable(a) == _stable(b) and a.matched == 2
    bad = ScanJob(matcher, [str(corpus), str(tmp_path / "missing.txt")], batch_size=4,
                  prefetch=2)
    with pytest.raises(FileNotFoundError):
        bad.run()


def test_scan_job_layouts_and_backends_agree(tmp_path):
    """The tiled matcher (pretiled per batch), the [B, L] witness matcher
    and the table-driven matcher count the same (tests/test_tiled_input.py
    ``test_scanjob_adopts_tiled_matcher``); the tiled job warns below the
    throughput batch."""
    model = T.zoo.email_headers_model(max_chars_size=64, headers=("from",))
    lines = []
    for i in range(37):
        lines += [b"from:a%d@b.cd\r" % i, b"nope %d" % i]
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(b"\n".join(lines) + b"\n")
    outs = []
    for m in (T.BitplaneMatcher(model, columns="match", device="cpu"),
              T.BitplaneMatcher(model, columns="match", input_layout="tiled", device="cpu"),
              T.BitplaneMatcher(model, columns="witness", device="cpu"),
              T.PallasMatcher(model, device="cpu")):
        outs.append(_stable(ScanJob(m, [str(corpus)], batch_size=16, keep_newline=True).run()))
    assert all(o == outs[0] for o in outs)
    assert (outs[0]["strings"], outs[0]["matched"]) == (74, 37)


def test_scan_job_tiled_warns_below_throughput_batch(tmp_path, capsys):
    model = T.zoo.email_headers_model(max_chars_size=64, headers=("from",))
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"nope\n")
    m = T.BitplaneMatcher(model, columns="match", input_layout="tiled", device="cpu")
    ScanJob(m, [str(corpus)], batch_size=16).run()
    assert "batch_size=16" in capsys.readouterr().err


def test_scan_job_device_expand_waits_for_portable_scan(tmp_path):
    """The device-expand job (raw chunk upload, rows gathered by
    ``expand_rows``; tiled words by ``tile_corpus_device``) counts what the
    host-packed job counts, with a bitplane matcher in both layouts."""
    model = _regex3()
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"\n".join([b"from:a@b.cd\r", b"nope", b"x" * 40, b""] * 9) + b"\n")
    for m in (T.BitplaneMatcher(model, columns="match", device="cpu"),
              T.BitplaneMatcher(model, columns="match", input_layout="tiled", device="cpu")):
        outs = [_stable(ScanJob(m, [str(corpus)], batch_size=8, keep_newline=True,
                                chunk_bytes=64, device_expand=dx).run())
                for dx in (False, True)]
        assert outs[0] == outs[1]
        assert (outs[0]["strings"], outs[0]["matched"]) == (36, 9)


# ---------------------------------------------------------------------------
# Counters and the backend ladder
# ---------------------------------------------------------------------------


def test_counters_on_torch_tensors():
    """A batch's verdicts given as torch tensors (a RegexResult or an
    emission dict) count as their numpy copies do; lengths may be either."""
    ok = torch.tensor([True, False, True, True])
    dead = torch.tensor([[False, False], [True, False], [False, False], [False, True]])
    lengths = np.array([3, 5, 0, 7], np.int32)
    a, b = Counters(), Counters()
    a.update({"match_ok": ok, "has_dead": dead}, torch.from_numpy(lengths), n_valid=3)
    b.update({"match_ok": ok.numpy(), "has_dead": dead.numpy()}, lengths, n_valid=3)
    assert _stable(a) == _stable(b) == dict(batches=1, strings=3, bytes_scanned=8, matched=2,
                                            failed=1, dead=1)
    res = T.RegexResult(*(None,) * 14, accepted=None, has_dead=dead, match_ok=ok)
    c = Counters()
    c.update(res, lengths)
    assert (c.strings, c.matched, c.dead) == (4, 3, 2)
    assert set(json.loads(c.to_json())) == set(_stable(c)) | {"wall_seconds", "bytes_per_sec"}


def test_best_matcher_ladder(monkeypatch):
    """auto: bitplane first, the table-driven matcher when the bitplane
    constructor refuses the model, the portable scan when both refuse; a
    missing CUDA device is not a refusal."""
    from halo2_regex_tpu_torch.ops import bitplane, pallas_scan

    model = _regex3()
    m, name = best_matcher(model, device="cpu", columns="match")
    assert name == "bitplane" and m.columns == "match"

    def refuse(*a, **k):
        raise NotImplementedError("refused")

    monkeypatch.setattr(bitplane, "BitplaneMatcher", refuse)
    m, name = best_matcher(model, device="cpu", columns="match")
    assert name == "pallas" and isinstance(m, T.PallasMatcher)
    with pytest.raises(NotImplementedError, match="refused"):
        best_matcher(model, backend="bitplane", device="cpu")
    m, name = best_matcher(model, backend="xla", device="cpu", columns="match")
    assert name == "xla" and isinstance(m, T.BatchMatcher)
    monkeypatch.setattr(pallas_scan, "PallasMatcher", refuse)
    m, name = best_matcher(model, device="cpu", columns="match")
    assert name == "xla" and isinstance(m, T.BatchMatcher)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        best_matcher(model)
