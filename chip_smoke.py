"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``halo2_regex_tpu_torch.BitplaneMatcher(model, columns="witness",
device="cuda")`` on the zk-email ``from:`` header model at bench.py's
shape (B=32768 strings x L=1024 bytes, bench.py's synthetic corpus, seed
0), and proves on the card that:

  1. the card is there (name and power limit from nvidia-smi, versions);
  2. the CUDA kernels build from the sources in this checkout (nvcc);
  3. the model compiles and the corpus is built;
  4. each kernel (K1 qpack, K2 scan, K3 post) is bit-exact against its
     plain PyTorch version on the same inputs at that size;
  5. the end-to-end witness equals the plain pipeline on the card (all
     eight keys), and a 256-string subset equals the numpy oracle; the
     main-path run launched every kernel (launch counts reset just
     before it);
  6. timings with CUDA events (2 warm-ups, 10 timed runs, median and
     IQR; L2 flushed before each timed run): each kernel's device time
     beside its plain version's, and the pipeline end to end as a caller
     sees one call (host launch overhead included).

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

import numpy as np
import torch

B, L = 32768, 1024
WARMUP, ITERS = 2, 10
ORACLE_N = 256
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


def time_ms(fn, flush: torch.Tensor, device_only: bool) -> dict:
    """Median and IQR of ``fn`` in ms from CUDA events; the L2 cache is
    flushed (a write larger than it) before each run, outside the window.
    ``device_only``: a ~1 ms device spin is queued before the window, so
    the host has launched ``fn`` before the card reaches the start event
    and the window holds device time only (no host launch overhead).
    Without it the window is what one call costs a caller."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(ITERS):
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
            "all": [float(x) for x in ms]}


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    return int((a.long() - b.long()).abs().max().item())


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import bitplane as bp
    from halo2_regex_tpu_torch.ops import kernels
    from halo2_regex_tpu_torch.ops.reference import match_substrs

    rec: dict = {}
    dev = torch.device("cuda")
    card = smi()
    rec["card"] = card
    rec["versions"] = versions()
    log(f"[1] card: {card}")
    log(f"[1] versions: {json.dumps(rec['versions'])}")

    t0 = time.perf_counter()
    model = h2r.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    t_model = time.perf_counter() - t0
    matcher = h2r.BitplaneMatcher(model, columns="witness", device=dev)
    plan = matcher.plan
    t0 = time.perf_counter()
    kernels.build(plan)
    t_build = time.perf_counter() - t0
    info = next(iter(kernels.BUILD_LOG.values()), {})
    regs = [ln.strip() for ln in str(info.get("ptxas", "")).splitlines()
            if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    rec["build"] = {"seconds": t_build, "dir": info.get("dir"), "ptxas": regs}
    log(f"[2] kernels built in {t_build:.1f} s "
        f"({info.get('dir', 'already built in this checkout')})")
    for ln in regs:
        log(f"[2]   {ln}")
    c = plan.circuits[0]
    log(f"[3] model compiled in {t_model:.1f} s: step {c.step_ops} ops, "
        f"{len(c.live_states)} live states, sb={c.sb}, KP={plan.kp}, "
        f"class {c.class_prog.n_ops} ops, tag {c.tag_ops} ops, "
        f"groups {[[n for n, _o, _b in g] for g in plan.wgroups]}")
    t0 = time.perf_counter()
    chars_np, lengths_np = bench_corpus(B, L)
    log(f"[3] corpus B={B} L={L} built in {time.perf_counter() - t0:.1f} s")

    chars = torch.from_numpy(chars_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    tables = matcher.tables()
    len_wb = bp.len_table(lengths)

    # [4] each kernel against its plain version on the same inputs
    bits_p, en_p = bp.qpack_plain(plan, chars, len_wb)
    logs_p = bp.scan_plain(plan, bits_p)
    post_p = bp.post_plain(plan, logs_p, en_p)
    stages = {
        "qpack": (kernels.QPACK, lambda: kernels.qpack_cuda(plan, chars, len_wb),
                  lambda: bp.qpack_plain(plan, chars, len_wb), (bits_p, en_p)),
        "scan": (kernels.SCAN, lambda: kernels.scan_cuda(plan, bits_p),
                 lambda: bp.scan_plain(plan, bits_p), logs_p),
        "post": (kernels.POST, lambda: kernels.post_cuda(plan, logs_p, en_p),
                 lambda: bp.post_plain(plan, logs_p, en_p), post_p),
    }
    errs = {}
    for name, (k, run_k, _run_p, want) in stages.items():
        got = run_k()
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, want)
        log(f"[4] {name}: kernel vs plain max_abs_err={errs[name]} "
            f"(tolerance 0, integer outputs)")
        if errs[name] != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain version")

    # [5] the main path end to end, with launch counts
    kernels.reset_launch_counts()
    out = matcher(chars, lengths)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"[5] main-path launches: {launches}")
    missing = [n for n, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    ref = bp.witness(plan, tables, chars, lengths, plain=True)
    torch.cuda.synchronize()
    for key in KEYS:
        a, b = out[key], ref[key]
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"witness[{key}] differs from the plain pipeline")
    log(f"[5] witness equals the plain pipeline on all {len(KEYS)} keys")
    rng = np.random.default_rng(1)
    idx = np.sort(rng.choice(B, size=ORACLE_N, replace=False))
    host = {k: out[k][torch.from_numpy(idx).to(dev)].cpu().numpy() for k in KEYS}
    for r, i in enumerate(idx):
        o = match_substrs(model.regex_defs, bytes(chars_np[i, : lengths_np[i]]), L)
        for key, want in (("states", o.states), ("all_substr_ids", o.all_substr_ids),
                          ("masked_characters", o.masked_characters),
                          ("mask", o.mask), ("match_ok", o.match_ok)):
            got = host[key][r]
            if not np.array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64)):
                raise AssertionError(f"string {i}: {key} differs from the oracle")
    n_ok = int(out["match_ok"].sum().item())
    rec["match_ok"] = n_ok
    log(f"[5] {ORACLE_N} strings equal the numpy oracle; match_ok {n_ok}/{B}; "
        f"shapes ok: states {tuple(out['states'].shape)}")

    # [6] timings
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    kern_rows = []
    times = {}
    for name, (k, run_k, run_p, _want) in stages.items():
        tk = time_ms(run_k, flush, device_only=True)
        tp = time_ms(run_p, flush, device_only=True)
        times[name] = {"kernel": tk, "plain": tp}
        log(f"[6] {name}: kernel {tk['median']:.4f} ms (IQR {tk['iqr'][0]:.4f}-"
            f"{tk['iqr'][1]:.4f}), plain {tp['median']:.4f} ms (IQR "
            f"{tp['iqr'][0]:.4f}-{tp['iqr'][1]:.4f})")
        kern_rows.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": errs[name], "ms": tk["median"],
            "plain_ms": tp["median"],
        })
    torch.cuda.reset_peak_memory_stats()
    e2e = time_ms(lambda: matcher(chars, lengths), flush, device_only=False)
    peak = torch.cuda.max_memory_allocated()
    e2e_plain = time_ms(lambda: bp.witness(plan, tables, chars, lengths, plain=True),
                        flush, device_only=False)
    gbs = B * L / (e2e["median"] * 1e-3) / 1e9
    times["end_to_end"] = {"kernel": e2e, "plain": e2e_plain}
    log(f"[6] end to end: {e2e['median']:.4f} ms/batch (IQR {e2e['iqr'][0]:.4f}-"
        f"{e2e['iqr'][1]:.4f}), {gbs:.3f} GB/s of input; plain pipeline "
        f"{e2e_plain['median']:.4f} ms; peak memory {peak / 2**20:.1f} MiB; "
        f"card {card}")
    rec.update(times=times, input_gb_per_s=gbs, peak_bytes=peak, kernels=kern_rows)
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
