"""Smoke run of the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``halo2_regex_tpu_torch.BitplaneMatcher(model, columns=...,
device="cuda")`` on the zk-email ``from:`` header model at bench.py's
shape (B=32768 strings x L=1024 bytes, bench.py's synthetic corpus, seed
0), through each of its paths:

  witness   columns="witness" (bench.py's headline): K1 qpack, K2 scan,
            K3 post;
  match     columns="match" (corpus filtering): qpack, scan, fb_only;
  full      columns="full" (the default RegexResult) and extraction
            serving (``extract_runs`` on its masked columns, as
            benchmarks/run_benchmarks.py's extract-serving rows): qpack,
            scan, post_planes;
  L=1000    the witness path on the model at max_chars_size=1000 (L_pad
            1024): pack_raw replaces qpack.

and proves on the card that:

  1. the card is there (name and power limit from nvidia-smi, versions);
  2. the CUDA kernels build from the sources in this checkout (nvcc, one
     library per path, all built at once);
  3. the models compile and the corpora are built;
  4. each of the six kernels is bit-exact against its plain PyTorch
     version on the same inputs at that size;
  5. each path, driven once through the matcher with the launch counts
     reset just before it, launched each of its kernels and no other, and
     equals its plain pipeline on the card (every output, dtypes
     included); a 256-string subset equals the numpy oracle, and for
     extraction serving the runs equal the oracle's extracted substrings;
  6. timings with CUDA events (2 warm-ups, 10 timed runs, median and
     IQR; L2 flushed before each timed run): each kernel's device time
     beside its plain version's, each path end to end as a caller sees one
     call (host launch overhead included) with its peak device memory, the
     B=4096 latency of match and extraction serving, and the plain
     pipelines (the witness one with 2 + 10 runs, the others, at about
     2.3 s a call, with PLAIN_WARMUP + PLAIN_ITERS).

Prints one JSON line of per-kernel results, then the nvidia-smi line, then
as its last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero without that line, as does a machine without CUDA.  A full
record goes to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, L = 32768, 1024
L_UNPADDED = 1000  # L_pad 1024: the raw-quads pack (B5) path
B_LATENCY = 4096  # the suite's latency rows
WARMUP, ITERS = 2, 10
PLAIN_WARMUP, PLAIN_ITERS = 1, 3
ORACLE_N = 256
EXTRACT = dict(max_runs=4, max_len=32)  # run_benchmarks._extract_serving
KEYS = ("states", "all_substr_ids", "masked_characters", "flags", "mask",
        "accepted", "has_dead", "match_ok")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def versions() -> dict:
    from halo2_regex_tpu_torch.ops import kernels

    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        nv = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout
        out["nvcc"] = nv.strip().splitlines()[-1]
    except (RuntimeError, subprocess.CalledProcessError) as e:
        out["nvcc"] = f"unavailable ({e})"
    try:
        import triton

        out["triton"] = triton.__version__
    except ImportError:
        out["triton"] = "not installed"
    return out


def bench_corpus(n: int, length: int, seed: int = 0):
    """bench.py's synthetic from: corpus (bench.py:122-135), same rng calls."""
    rng = np.random.default_rng(seed)
    chars = np.zeros((n, length), np.uint8)
    lengths = np.zeros((n,), np.int32)
    domains = [b"gmail.com", b"x.yz", b"sub.domain-x.org"]
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    alpha_sp = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    for i in range(n):
        name = rng.choice(alpha, size=8).tobytes()
        filler_len = int(rng.integers(0, max(1, length - 96)))
        filler = rng.choice(alpha_sp, size=filler_len).tobytes()
        s = filler + b"\r\nfrom:" + name + b"@" + domains[i % 3] + b"\r\n"
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


def time_ms(fn, flush: torch.Tensor, device_only: bool, warmup: int = WARMUP,
            iters: int = ITERS) -> dict:
    """Median and IQR of ``fn`` in ms from CUDA events; the L2 cache is
    flushed (a write larger than it) before each run, outside the window.
    ``device_only``: a ~1 ms device spin is queued before the window, so
    the host has launched ``fn`` before the card reaches the start event
    and the window holds device time only (no host launch overhead).
    Without it the window is what one call costs a caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in pairs])
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "iqr": [float(q1), float(q3)],
            "all": [float(x) for x in ms], "runs": iters}


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max().item())


def as_dict(out) -> dict:
    """A path's output (witness/match dict or RegexResult) as a dict."""
    return out if isinstance(out, dict) else vars(out)


def assert_same(path: str, got, want) -> None:
    got, want = as_dict(got), as_dict(want)
    if set(got) != set(want):
        raise AssertionError(f"{path}: keys {sorted(got)} vs {sorted(want)}")
    for key in want:
        a, b = got[key], want[key]
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{path}[{key}] differs from the plain pipeline")


def fmt(t: dict) -> str:
    return f"{t['median']:.4f} ms (IQR {t['iqr'][0]:.4f}-{t['iqr'][1]:.4f})"


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import bitplane as bp
    from halo2_regex_tpu_torch.ops import kernels
    from halo2_regex_tpu_torch.ops.reference import extract_substrings, match_substrs

    rec: dict = {}
    dev = torch.device("cuda")
    card = smi()
    rec["card"] = card
    rec["versions"] = versions()
    log(f"[1] card: {card}")
    log(f"[1] versions: {json.dumps(rec['versions'])}")

    # [2] one matcher (and kernel library) per path, built at once
    t0 = time.perf_counter()
    model = h2r.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    model_u = h2r.zoo.email_headers_model(max_chars_size=L_UNPADDED, headers=("from",))
    t_model = time.perf_counter() - t0
    matchers = {
        "witness": h2r.BitplaneMatcher(model, columns="witness", device=dev),
        "match": h2r.BitplaneMatcher(model, columns="match", device=dev),
        "full": h2r.BitplaneMatcher(model, device=dev),
        "L1000": h2r.BitplaneMatcher(model_u, columns="witness", device=dev),
    }
    if matchers["full"].columns != "full" or matchers["L1000"].plan.qpack:
        raise AssertionError("default columns or the L=1000 pack route changed")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(matchers)) as pool:
        list(pool.map(kernels.build, [m.plan for m in matchers.values()]))
    t_build = time.perf_counter() - t0
    regs = []
    for info in kernels.BUILD_LOG.values():
        regs += [ln.strip() for ln in str(info.get("ptxas", "")).splitlines()
                 if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    rec["build"] = {"seconds": t_build, "libraries": {
        k: {"seconds": v["seconds"], "dir": v["dir"]} for k, v in kernels.BUILD_LOG.items()},
        "ptxas": regs}
    log(f"[2] {len(kernels.BUILD_LOG)} kernel libraries built in {t_build:.1f} s "
        f"(each {[round(v['seconds'], 1) for v in kernels.BUILD_LOG.values()]} s)")
    for ln in regs:
        log(f"[2]   {ln}")
    plan = matchers["witness"].plan
    c = plan.circuits[0]
    log(f"[3] models compiled in {t_model:.1f} s: step {c.step_ops} ops, "
        f"{len(c.live_states)} live states, sb={c.sb}, KP={plan.kp}, "
        f"class {c.class_prog.n_ops} ops, tag {c.tag_ops} ops, "
        f"groups {[[n for n, _o, _b in g] for g in plan.wgroups]}, "
        f"full post planes {list(matchers['full'].plan.post_off)}")
    t0 = time.perf_counter()
    corpora = {L: bench_corpus(B, L), L_UNPADDED: bench_corpus(B, L_UNPADDED)}
    log(f"[3] corpora B={B} x L={L} and L={L_UNPADDED} built in "
        f"{time.perf_counter() - t0:.1f} s")
    inputs = {Lc: (torch.from_numpy(c_).to(dev), torch.from_numpy(l_).to(dev))
              for Lc, (c_, l_) in corpora.items()}
    chars, lengths = inputs[L]
    chars_u, lengths_u = inputs[L_UNPADDED]

    # [4] each kernel against its plain version on the same inputs
    pf, pm, pu = (matchers[k].plan for k in ("full", "match", "L1000"))
    len_wb = bp.len_table(lengths)
    len_wb_u = bp.len_table(lengths_u)
    quads_u = bp.raw_quads(chars_u, pu.L_pad)
    bits_p, en_p = bp.qpack_plain(plan, chars, len_wb)
    logs_p = bp.scan_plain(plan, bits_p)
    stages = {
        "qpack": (kernels.QPACK, lambda: kernels.qpack_cuda(plan, chars, len_wb),
                  lambda: bp.qpack_plain(plan, chars, len_wb)),
        "scan": (kernels.SCAN, lambda: kernels.scan_cuda(plan, bits_p),
                 lambda: bp.scan_plain(plan, bits_p)),
        "post": (kernels.POST, lambda: kernels.post_cuda(plan, logs_p, en_p),
                 lambda: bp.post_plain(plan, logs_p, en_p)),
        "fb_only": (kernels.FB_ONLY, lambda: kernels.fb_only_cuda(pm, logs_p, en_p),
                    lambda: bp.fb_only_plain(pm, logs_p, en_p)),
        "post_planes": (kernels.POST_PLANES, lambda: kernels.post_planes_cuda(pf, logs_p, en_p),
                        lambda: bp.post_planes_plain(pf, logs_p, en_p)),
        "pack_raw": (kernels.PACK_RAW, lambda: kernels.pack_raw_cuda(pu, quads_u, len_wb_u),
                     lambda: bp.pack_plain(pu, quads_u, len_wb_u)),
    }
    errs = {}
    for name, (k, run_k, run_p) in stages.items():
        want = (bits_p, en_p) if name == "qpack" else (logs_p if name == "scan" else run_p())
        got = run_k()
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, want)
        log(f"[4] {name}: kernel vs plain max_abs_err={errs[name]} "
            f"(tolerance 0, integer outputs)")
        if errs[name] != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain version")
        del got, want

    # [5] each path once through the matcher, with launch counts
    rng = np.random.default_rng(1)
    idx = np.sort(rng.choice(B, size=ORACLE_N, replace=False))
    idx_t = torch.from_numpy(idx).to(dev)
    path_inputs = {"witness": inputs[L], "match": inputs[L], "full": inputs[L],
                   "L1000": inputs[L_UNPADDED]}
    outs, path_launches = {}, {}
    for path, m in matchers.items():
        ch, ln = path_inputs[path]
        kernels.reset_launch_counts()
        out = m(ch, ln)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels.KERNELS}
        expected = {k.name for k in kernels.path_kernels(m.plan)}
        log(f"[5] {path}: launches {launches}")
        wrong = [n for n, v in launches.items() if (v > 0) != (n in expected)]
        if wrong:
            raise AssertionError(f"{path}: launch counts wrong for {wrong} "
                                 f"(expected exactly {sorted(expected)})")
        assert_same(path, out, bp.run(m.plan, m.tables(), ch, ln, plain=True))
        torch.cuda.synchronize()
        outs[path], path_launches[path] = out, launches
        log(f"[5] {path}: equals the plain pipeline on all {len(as_dict(out))} outputs")

    # the oracle on a 256-string subset of each path
    checks = {
        "witness": ("states", "all_substr_ids", "masked_characters", "mask", "match_ok"),
        "match": ("accepted", "has_dead", "match_ok"),
        "full": tuple(h2r.RegexResult.field_names()),
        "L1000": ("states", "all_substr_ids", "masked_characters", "mask", "match_ok"),
    }
    oracle_rows = {}
    for path, keys in checks.items():
        Lc = L_UNPADDED if path == "L1000" else L
        c_np, l_np = corpora[Lc]
        o_model = model_u if path == "L1000" else model
        host = {k: as_dict(outs[path])[k][idx_t].cpu().numpy() for k in keys}
        for r, i in enumerate(idx):
            o = match_substrs(o_model.regex_defs, bytes(c_np[i, : l_np[i]]), Lc)
            if path == "full":
                oracle_rows[int(i)] = o
            for key in keys:
                if not np.array_equal(np.asarray(host[key][r]).astype(np.int64),
                                      np.asarray(getattr(o, key)).astype(np.int64)):
                    raise AssertionError(f"{path}: string {i}: {key} differs from the oracle")
        log(f"[5] {path}: {ORACLE_N} strings equal the numpy oracle on {list(keys)}")
    n_ok = {p: int(as_dict(o)["match_ok"].sum().item()) for p, o in outs.items()}
    rec["match_ok"] = n_ok
    log(f"[5] match_ok per path {n_ok} of {B}; full states "
        f"{tuple(outs['full'].states.shape)} {outs['full'].states.dtype}")

    # extraction serving: runs on the card == runs on the plain output ==
    # the oracle's extracted substrings
    def serve(m, ch, ln):
        res = m(ch, ln)
        runs = h2r.extract_runs(res.all_substr_ids, res.masked_characters, **EXTRACT)
        runs["match_ok"] = res.match_ok
        return runs

    full_m = matchers["full"]
    runs = serve(full_m, chars, lengths)
    ref_full = bp.run(full_m.plan, full_m.tables(), chars, lengths, plain=True)
    runs_ref = h2r.extract_runs(ref_full.all_substr_ids, ref_full.masked_characters, **EXTRACT)
    runs_ref["match_ok"] = ref_full.match_ok
    assert_same("extract_runs", runs, runs_ref)
    del ref_full, runs_ref
    host_runs = {k: v[idx_t].cpu() for k, v in runs.items()}
    n_cmp = 0
    for r, i in enumerate(idx):
        want = extract_substrings(oracle_rows[int(i)])
        if len(want) <= EXTRACT["max_runs"] and all(len(t) <= EXTRACT["max_len"] for _o, t, _i in want):
            if h2r.runs_to_python(host_runs, r) != want:
                raise AssertionError(f"string {i}: extracted runs differ from the oracle")
            n_cmp += 1
        if int(host_runs["n_runs"][r]) != len(want):
            raise AssertionError(f"string {i}: n_runs differs from the oracle")
    if n_cmp < ORACLE_N // 2:
        raise AssertionError(f"only {n_cmp} strings fit max_runs/max_len")
    log(f"[5] extraction serving: runs equal the plain pipeline's; {n_cmp} of "
        f"{ORACLE_N} strings equal the oracle's extract_substrings (the rest "
        f"exceed max_runs/max_len; n_runs equal on all)")
    del outs, runs, host_runs

    # [6] timings
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    kern_rows, times = [], {}
    path_of = {"qpack": "witness", "scan": "witness", "post": "witness",
               "fb_only": "match", "post_planes": "full", "pack_raw": "L1000"}
    for name, (k, run_k, run_p) in stages.items():
        tk = time_ms(run_k, flush, device_only=True)
        tp = time_ms(run_p, flush, device_only=True)
        times[name] = {"kernel": tk, "plain": tp}
        log(f"[6] {name}: kernel {fmt(tk)}, plain {fmt(tp)}")
        kern_rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": path_launches[path_of[name]][k.name],
            "max_abs_err": errs[name], "ms": tk["median"], "plain_ms": tp["median"],
        })
    del bits_p, en_p, logs_p, quads_u

    e2e_paths = {
        "witness": (lambda: matchers["witness"](chars, lengths), "witness", inputs[L]),
        "match": (lambda: matchers["match"](chars, lengths), "match", inputs[L]),
        "full": (lambda: matchers["full"](chars, lengths), "full", inputs[L]),
        "extract_serving": (lambda: serve(full_m, chars, lengths), "full", inputs[L]),
        "L1000": (lambda: matchers["L1000"](chars_u, lengths_u), "L1000", inputs[L_UNPADDED]),
    }
    for path, (fn, mk, (ch, ln)) in e2e_paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time_ms(fn, flush, device_only=False)
        peak = torch.cuda.max_memory_allocated()
        m = matchers[mk]
        if path == "witness":
            tp = time_ms(lambda: bp.run(m.plan, m.tables(), ch, ln, plain=True), flush,
                         device_only=False)
        elif path != "extract_serving":
            tp = time_ms(lambda: bp.run(m.plan, m.tables(), ch, ln, plain=True), flush,
                         device_only=False, warmup=PLAIN_WARMUP, iters=PLAIN_ITERS)
        else:
            tp = None
        gbs = B * ch.shape[1] / (t["median"] * 1e-3) / 1e9
        times[f"end_to_end_{path}"] = {"kernel": t, "plain": tp, "peak_bytes": peak,
                                       "input_gb_per_s": gbs}
        plain_txt = (f"plain pipeline {fmt(tp)} over {tp['runs']} runs" if tp else
                     "plain: see full")
        log(f"[6] end to end {path}: {fmt(t)}, {gbs:.3f} GB/s of input; {plain_txt}; "
            f"peak memory {peak / 2**20:.1f} MiB; card {card}")
    for path, fn in (
        ("match", lambda: matchers["match"](chars[:B_LATENCY], lengths[:B_LATENCY])),
        ("extract_serving", lambda: serve(full_m, chars[:B_LATENCY], lengths[:B_LATENCY])),
    ):
        t = time_ms(fn, flush, device_only=False)
        times[f"latency_b{B_LATENCY}_{path}"] = {"kernel": t}
        log(f"[6] B={B_LATENCY} {path}: {fmt(t)} per call; card {card}")

    rec.update(times=times, launches=path_launches, kernels=kern_rows)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(json.dumps({"kernels": kern_rows}))
    log(smi())
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    try:
        result = main()
    except SystemExit:
        raise
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.exit(1)
    print(json.dumps(result), flush=True)
