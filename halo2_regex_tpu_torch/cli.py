"""Command-line interface of the PyTorch port (the JAX package's
``halo2_regex_tpu.cli``: the same commands, flags, messages and exit codes).

Reference parity (src/bin/vrm.rs:21-88):
  gen-halo2-texts  decomposed JSON -> allstr.txt + substr{i}.txt tables
  gen-circom       decomposed JSON -> circom template

Device commands:
  compile          decomposed JSON(s) -> dense .npz model artifact
  match            run the batched matcher over input strings and print
                   extracted substrings / acceptance
  handoff          dump the prover hand-off rows of one input (the
                   matcher's full witness) and re-verify them from the text
  explain          per-byte trace of one match (the numpy oracle)
  scan             stream a newline-delimited corpus through the matcher
                   (resumable ScanJob) and print match statistics
  bench            quick throughput measurement on one backend

``--device`` (match, handoff, scan, bench) is ``cuda`` by default, which raises
where CUDA is absent; ``--device cpu`` runs the kernels' plain versions
(the port's counterpart of ``JAX_PLATFORMS=cpu``).

Usage: python -m halo2_regex_tpu_torch <command> [args]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .ops import BACKENDS


def _cmd_gen_halo2_texts(args) -> int:
    from .compiler.decomposed import DecomposedRegexConfig

    cfg = DecomposedRegexConfig.from_json_file(args.decomposed_regex_path)
    n_public = sum(1 for p in cfg.parts if p.is_public)
    substr_dir = Path(args.substrs_dir_path)
    substr_dir.mkdir(parents=True, exist_ok=True)
    substr_paths = [substr_dir / f"substr{i}.txt" for i in range(n_public)]
    cfg.gen_regex_files(args.allstr_file_path, substr_paths)
    print(f"wrote {args.allstr_file_path} and {n_public} substr file(s) in {substr_dir}")
    return 0


def _cmd_gen_circom(args) -> int:
    from .compiler.circom import gen_circom
    from .compiler.decomposed import DecomposedRegexConfig

    cfg = DecomposedRegexConfig.from_json_file(args.decomposed_regex_path)
    gen_circom(cfg, args.circom_file_path, args.template_name)
    print(f"wrote {args.circom_file_path}")
    return 0


def _cmd_compile(args) -> int:
    from .compiler.decomposed import DecomposedRegexConfig
    from .models.compiled import CompiledRegexModel

    cfgs = [DecomposedRegexConfig.from_json_file(p) for p in args.decomposed_regex_paths]
    model = CompiledRegexModel.from_decomposed(cfgs, max_chars_size=args.max_chars_size)
    model.save(args.output)
    print(
        f"compiled {len(cfgs)} def(s): s_pad={model.s_pad}, "
        f"{model.total_substrs} substr(s), max_chars={model.max_chars_size} "
        f"-> {args.output}"
    )
    return 0


def _cmd_match(args) -> int:
    from .models.compiled import CompiledRegexModel
    from .ops import best_matcher
    from .ops.reference import extract_substrings
    from .utils.io import pack_batch

    model = CompiledRegexModel.load(args.model)
    if args.input_file:
        data = Path(args.input_file).read_bytes()
        strings = data.splitlines() if args.lines else [data]
    else:
        strings = [s.encode() for s in args.strings]
    if not strings:
        print("no input strings", file=sys.stderr)
        return 2
    matcher, _ = best_matcher(model, backend=args.backend, device=args.device)
    chars, lengths = pack_batch(strings, model.max_chars_size)
    res = matcher(chars, lengths).to_numpy()  # one fetch for the batch
    ok = res.match_ok
    n_bad = 0
    for i, s in enumerate(strings):
        row = res.map(lambda a: a[i])
        subs = extract_substrings(row)
        status = "MATCH" if ok[i] else "NO-MATCH"
        if not ok[i]:
            n_bad += 1
        print(json.dumps({
            "input": s.decode("latin-1"),
            "status": status,
            "substrings": [
                {"offset": o, "text": t, "substr_id": sid} for o, t, sid in subs
            ],
        }))
    return 1 if (args.strict and n_bad) else 0


def _cmd_handoff(args) -> int:
    """Prover hand-off: dump tables + assigned witness columns for one
    input as the self-describing row artifact (witness/handoff.py), then
    re-verify it from the text alone."""
    from .models.compiled import CompiledRegexModel
    from .ops import best_matcher
    from .utils.io import pack_batch
    from .witness.handoff import dump_prover_rows, load_prover_rows, verify_handoff

    model = CompiledRegexModel.load(args.model)
    s = args.string.encode("latin-1")
    if len(s) > model.max_chars_size:  # the numpy oracle's error in JAX's command
        raise ValueError(f"input length {len(s)} exceeds max_chars_size {model.max_chars_size}")
    # JAX's int32 columns (compact=False), one row of a batch of one
    matcher, _ = best_matcher(model, device=args.device, compact=False)
    result = matcher(*pack_batch([s], model.max_chars_size)).to_numpy().map(lambda a: a[0])
    if not bool(result.match_ok) and not args.allow_nonmatch:
        print("input does not match; pass --allow-nonmatch to dump anyway")
        return 1
    text = dump_prover_rows(
        model.regex_defs,
        result,
        meta={
            "model": args.model,
            "input": args.string.encode("unicode_escape").decode(),
            "max_chars_size": str(model.max_chars_size),
        },
    )
    Path(args.output).write_text(text)
    errors = verify_handoff(load_prover_rows(text))
    if errors:
        print(f"VERIFY FAILED: {errors[:3]}")
        return 1
    print(
        f"wrote {args.output} ({len(text.splitlines())} lines), "
        f"external-style verification clean"
    )
    return 0


def _cmd_explain(args) -> int:
    """Per-byte trace of a match: state sequence, substr ids, flags and
    masks (the debugging view of the witness columns)."""
    import numpy as np

    from .models.compiled import CompiledRegexModel
    from .ops.reference import extract_substrings, match_substrs

    model = CompiledRegexModel.load(args.model)
    s = args.string.encode("latin-1")
    result = match_substrs(model.regex_defs, s, model.max_chars_size)
    states = np.asarray(result.states)
    print(f"input: {args.string!r}")
    print(f"match_ok: {bool(result.match_ok)}  accepted per def: "
          f"{np.asarray(result.accepted).tolist()}")
    header = "pos  char  " + " ".join(f"st{d}" for d in range(model.n_defs)) + (
        "  id  start end  fwd bwd mask"
    )
    print(header)
    for i in range(len(s)):
        ch = chr(s[i]) if 32 <= s[i] < 127 else f"\\x{s[i]:02x}"
        sts = " ".join(f"{states[d, i + 1]:3d}" for d in range(model.n_defs))
        print(
            f"{i:3d}  {ch:>4}  {sts}  {int(result.substr_id_sum[i]):2d}  "
            f"{int(result.is_start_sum[i]):4d} {int(result.is_end_sum[i + 1]):3d}  "
            f"{int(result.fwd_mask[i]):3d} {int(result.bwd_mask[i]):3d} "
            f"{int(result.mask[i]):3d}"
        )
    print("extracted:", extract_substrings(result))
    return 0


def _cmd_scan(args) -> int:
    """Stream a newline-delimited corpus through the matcher; print summary
    statistics (and optionally per-match extractions)."""
    import numpy as np

    from .models.compiled import CompiledRegexModel
    from .ops import best_matcher
    from .ops.reference import extract_substrings
    from .utils.jobs import ScanJob

    model = CompiledRegexModel.load(args.model)
    # Counting-only scans take the match-only pipeline on the bitplane
    # backend; --print-matches needs the full column set for extraction.
    kw = {} if args.print_matches else {"columns": "match"}
    backend = args.backend
    if args.input_layout == "tiled":
        # tiled is a bitplane-only contract; ScanJob pre-tiles each batch
        # on the host (ops.bitplane.tile_corpus, C++ packer)
        if args.print_matches:
            print(
                "error: --input-layout tiled supports counting scans "
                "only (--print-matches needs the full column set)",
                file=sys.stderr,
            )
            return 2
        if backend not in ("auto", "bitplane"):
            print(
                f"error: --input-layout tiled requires the bitplane "
                f"backend (got --backend {backend})",
                file=sys.stderr,
            )
            return 2
        backend = "bitplane"
        kw["input_layout"] = "tiled"
    matcher, _ = best_matcher(model, backend=backend, device=args.device, **kw)

    def _print_matches(res, chars, lengths, n_valid):
        if not args.print_matches:
            return
        res = res.to_numpy()
        for i in np.nonzero(res.match_ok[:n_valid])[0]:
            if lengths[i] == 0:
                continue
            row = res.map(lambda a: a[i])
            print(json.dumps({
                "input": bytes(chars[i][: lengths[i]]).decode("latin-1"),
                "substrings": [
                    {"offset": o, "text": t, "substr_id": s}
                    for o, t, s in extract_substrings(row)
                ],
            }))

    # ScanJob handles both modes (checkpoint_path=None = plain scan) and
    # pipelines read+pack with the device.
    job = ScanJob(
        matcher, args.corpus, checkpoint_path=args.checkpoint,
        batch_size=args.batch, on_batch=_print_matches,
        keep_newline=args.keep_newline,
    )
    counters = job.run()
    print(counters.to_json())
    n_trunc = job.n_truncated
    if n_trunc:
        print(
            f"warning: {n_trunc} line(s) longer than "
            f"{model.max_chars_size} bytes were truncated",
            file=sys.stderr,
        )
    return 0


def _cmd_bench(args) -> int:
    import time

    import numpy as np
    import torch

    from .models.compiled import CompiledRegexModel
    from .ops import best_matcher

    model = CompiledRegexModel.load(args.model)
    rng = np.random.default_rng(0)
    B, L = args.batch, model.max_chars_size
    chars = rng.integers(32, 127, size=(B, L)).astype(np.uint8)
    lengths = np.full((B,), L, np.int32)
    matcher, backend_name = best_matcher(model, backend=args.backend, device=args.device)
    dev = matcher.device
    chars_d = torch.from_numpy(chars).to(dev)
    lengths_d = torch.from_numpy(lengths).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    matcher(chars_d, lengths_d)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        matcher(chars_d, lengths_d)
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    print(
        json.dumps(
            {
                "backend": backend_name,
                "platform": dev.type,
                "batch": B,
                "max_chars": L,
                "sec_per_batch": dt,
                "bytes_per_sec": B * L / dt,
            }
        )
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="halo2_regex_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the matcher runs (cuda raises without CUDA)")

    p = sub.add_parser("gen-halo2-texts", help="decomposed JSON -> text tables")
    p.add_argument("--decomposed-regex-path", required=True)
    p.add_argument("--allstr-file-path", required=True)
    p.add_argument("--substrs-dir-path", required=True)
    p.set_defaults(fn=_cmd_gen_halo2_texts)

    p = sub.add_parser("gen-circom", help="decomposed JSON -> circom template")
    p.add_argument("--decomposed-regex-path", required=True)
    p.add_argument("--circom-file-path", required=True)
    p.add_argument("--template-name", required=True)
    p.set_defaults(fn=_cmd_gen_circom)

    p = sub.add_parser("compile", help="decomposed JSON(s) -> .npz model artifact")
    p.add_argument("decomposed_regex_paths", nargs="+")
    p.add_argument("--max-chars-size", type=int, default=1024)
    p.add_argument("--output", "-o", required=True)
    p.set_defaults(fn=_cmd_compile)

    p = sub.add_parser("match", help="run the batched matcher on inputs")
    p.add_argument("--model", required=True)
    p.add_argument("--input-file")
    p.add_argument("--lines", action="store_true", help="treat input file as one string per line")
    p.add_argument("--strict", action="store_true", help="exit 1 if any input fails")
    p.add_argument("strings", nargs="*")
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    device_arg(p)
    p.set_defaults(fn=_cmd_match)

    p = sub.add_parser("handoff", help="dump prover hand-off rows for one input")
    p.add_argument("--model", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--allow-nonmatch", action="store_true")
    p.add_argument("string")
    device_arg(p)
    p.set_defaults(fn=_cmd_handoff)

    p = sub.add_parser("explain", help="per-byte trace of one match")
    p.add_argument("--model", required=True)
    p.add_argument("string")
    p.set_defaults(fn=_cmd_explain)

    p = sub.add_parser("scan", help="stream a corpus; print match statistics")
    p.add_argument("--model", required=True)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--print-matches", action="store_true")
    p.add_argument("--checkpoint", help="JSON state file for resumable jobs")
    p.add_argument("corpus", nargs="+", help="newline-delimited corpus file(s)")
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    p.add_argument("--keep-newline", action="store_true",
                   help="restore each line's \\n terminator (required for "
                        "models whose accept state needs \\r\\n, e.g. the "
                        "email headers)")
    p.add_argument("--input-layout", default="bl", choices=["bl", "tiled"],
                   help="'tiled': pack each batch into the pretiled "
                        "quad-word buffer on the host (C++ packer) so the "
                        "device skips the strided [B, L] read; counting "
                        "scans on the bitplane backend only")
    device_arg(p)
    p.set_defaults(fn=_cmd_scan)

    p = sub.add_parser("bench", help="throughput measurement")
    p.add_argument("--model", required=True)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    device_arg(p)
    p.set_defaults(fn=_cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, KeyError, FileNotFoundError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
