"""Time the port's redesigned kernels against an earlier version of the
package, on one NVIDIA GPU.

    git archive <commit> halo2_regex_tpu_torch | tar -x -C build/ab_old
    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch

``--old`` is a directory holding the earlier ``halo2_regex_tpu_torch/``,
imported as ``h2r_old``: its own kernels module builds its ``csrc/`` by
the same nvcc route into the same build root.  Every pair runs on the
same inputs, is checked equal (and equal to the plain version), and is
timed in turns, old, new, new, old (CUDA events, L2 flushed;
chip_smoke's ``time_ms``: device-only windows for kernels, a caller's
window for walls).

Kernels, on the zk-email ``from:`` model at bench.py's shape (B=32768 x
L=1024, bench.py's corpus):
  qpack     K1 in each mode: binary and one-hot class planes, class stage
            off, en_pack off; the new one against its variants
            (``QPACK_VARIANTS``: copies of ``csrc/`` with one edit); and at
            L=36 (where 16-byte loads do not fit), old against new and the
            new kernel's 4-byte loads against its byte loads;
  table_fsm  the one-pass mask FSMs of pallas_from (both directions; the
            new kernel's backward codes in shared memory and in a global
            scratch) on the planes of the tag kernel;
  pack_raw, tpack, scan_fpack, post_tiled  the kernels that share K1's
            byte-plane helper (``h2r_byte_planes``), each in its path's
            mode.
ptxas' registers, shared memory and spills of qpack's and the one-pass
FSM's entries.

Walls, old package against new, with equal outputs, 30 runs each:
witness, witness_direct, match, full, tiled_witness, L1000 witness
(pack_raw), pallas_from (B=32768) and pallas_large (BASELINE configs[3]).

The record goes to ``chiprun_out/kernel_ab.json``; the last line is a
JSON summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WALL_ITERS = 30  # the walls move with the host: more runs than a kernel's 10
QPACK_MODES = {"binary": {}, "onehot": dict(class_stage="onehot"),
               "off": dict(class_stage=False), "en_off": dict(en_pack=False)}


def import_old(old_pkg: Path):
    """The earlier package at ``old_pkg``, imported as ``h2r_old`` (its
    imports are relative, so it loads beside the checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "h2r_old", old_pkg / "__init__.py", submodule_search_locations=[str(old_pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["h2r_old"] = mod
    spec.loader.exec_module(mod)
    return mod, importlib.import_module("h2r_old.ops.kernels")


def in_turns(cs, name, run_old, run_new, flush, card, device_only=True, iters=10) -> dict:
    """old, new, new, old, ``iters`` runs each; prints and returns the
    medians and every run."""
    t = [cs.time_ms(f, flush, device_only=device_only, iters=iters)
         for f in (run_old, run_new, run_new, run_old)]
    print(f"{name}: old {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, new "
          f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms (old, new, new, old; outputs equal); "
          f"card {card}", flush=True)
    return {"old": [t[0]["median"], t[3]["median"]], "new": [t[1]["median"], t[2]["median"]],
            "iqr": [x["iqr"] for x in t], "runs": [x["all"] for x in t]}


def ptxas_of(K, keys, kernel: str) -> list:
    """ptxas' lines for the entries whose mangled name holds ``kernel`` in
    the libraries ``keys`` of the build log: registers, smem, spills."""
    out = []
    for key in keys:
        lines = str(K.BUILD_LOG[key]["ptxas"]).splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and kernel in ln:
                out.append(" | ".join(x.strip() for x in lines[i: i + 4]))
    return out


class Pkgs:
    """The new and the old package's modules, side by side."""

    def __init__(self, h2r, old, K, old_k):
        self.h2r, self.old, self.K, self.old_k = h2r, old, K, old_k
        self.bp = importlib.import_module("halo2_regex_tpu_torch.ops.bitplane")
        self.knobs = importlib.import_module("halo2_regex_tpu_torch.ops.knobs")
        self.obp = importlib.import_module("h2r_old.ops.bitplane")
        self.oknobs = importlib.import_module("h2r_old.ops.knobs")

    def plans(self, L, tiled=False, **kw):
        """(old plan, new plan) of the from: model's witness path."""
        out = []
        for pkg, bp, kn in ((self.old, self.obp, self.oknobs), (self.h2r, self.bp, self.knobs)):
            model = pkg.zoo.email_headers_model(max_chars_size=L, headers=("from",))
            out.append(bp.make_plan(model, "witness", knobs=kn.BitplaneKnobs.from_env(**kw),
                                    tiled=tiled))
        return tuple(out)


def check(cs, name, got, want):
    torch.cuda.synchronize()
    if cs.max_abs_err(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")


def variant_csrc(K, name: str, edits) -> Path:
    """A copy of ``csrc/`` under the build root with ``edits`` (file, text,
    replacement) applied; each text must be there."""
    var_dir = K.build_root().parent / f"ab_{name}" / "csrc"
    if var_dir.exists():
        shutil.rmtree(var_dir)
    shutil.copytree(K.CSRC, var_dir)
    for fname, old, new in edits:
        text = (var_dir / fname).read_text()
        if old not in text:
            raise AssertionError(f"variant {name}: no {old!r} in csrc/{fname}")
        (var_dir / fname).write_text(text.replace(old, new))
    return var_dir


# qpack's variants: four blocks an SM asked of the register allocator;
# and, for timing only (their outputs are not qpack's), the kernel without
# its global loads of the bytes and without its bit work
QPACK_VARIANTS = {
    "lb4": [("bitplane_pack.cu", "__launch_bounds__(THREADS, VEC == 0 ? 2 : 3)",
             "__launch_bounds__(THREADS, 4)")],
    "no_load": [("bitplane_pack.cu",
                 "    if (l < L) u = __ldg(reinterpret_cast<const uint4*>(row + l));",
                 "    u.x = (uint32_t)(size_t)row ^ (uint32_t)l;")],
    "no_compute": [("bitplane_pack.cu",
                    "    h2r_byte_planes(q, bb);\n    uint32_t cls[H2R_KP];\n"
                    "    h2r_class(bb, cls);",
                    "    uint32_t cls[H2R_KP];\n#pragma unroll\n"
                    "    for (int k = 0; k < H2R_KP; ++k) cls[k] = q[k % 8];")],
}
QPACK_TIMING_ONLY = ("no_load", "no_compute")
# the one-pass FSMs' loads: batches of 32 positions
FSM_VARIANTS = {
    "step32": [("table_fsm.cu", "constexpr int kPassStep = 16;", "constexpr int kPassStep = 32;")],
}


def sass_counts(K, keys, kernel: str) -> list:
    """The SASS instruction count of each entry whose name holds
    ``kernel`` in the libraries ``keys`` (cuobjdump), by opcode class."""
    cuobjdump = Path(K._nvcc()).parent / "cuobjdump"
    out = []
    for key in keys:
        so = Path(str(K.BUILD_LOG[key]["dir"])) / "libh2r.so"
        res = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True)
        fn, ops = None, {}
        for ln in res.stdout.splitlines():
            if "Function :" in ln:
                if fn and kernel in fn:
                    out.append({"function": fn, "instructions": sum(ops.values()), "ops": ops})
                fn, ops = ln.split("Function :", 1)[1].strip(), {}
            elif fn and "/*" in ln and ";" in ln:
                ins = ln.split("*/", 1)[1].strip().split()
                if ins and ins[0].startswith("@"):
                    ins = ins[1:]
                if ins:
                    op = ins[0].split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
        if fn and kernel in fn:
            out.append({"function": fn, "instructions": sum(ops.values()), "ops": ops})
    for r in out:
        top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:12]
        print(f"sass {r['function'][-60:]}: {r['instructions']} instructions; {top}", flush=True)
    return out


def qpack_ab(pk: Pkgs, cs, dev, card, flush, chars, len_wb) -> dict:
    """qpack, old against new, in each mode; the new one against its
    variants, and without the L2 flush; at L=36, old against new and the
    load instances (``vec`` 1 against 0) of the new one."""
    K, old_k, bp = pk.K, pk.old_k, pk.bp
    plans = {mode: pk.plans(cs.L, **kw) for mode, kw in QPACK_MODES.items()}
    pn = plans["binary"][1]
    header = K.circuits_header(pn)
    var_dirs = {name: variant_csrc(K, f"qpack_{name}", edits)
                for name, edits in QPACK_VARIANTS.items()}
    before, before_old = set(K.BUILD_LOG), set(old_k.BUILD_LOG)
    with ThreadPoolExecutor(12) as pool:
        jobs = [pool.submit(k.build, p) for po, pn_ in plans.values()
                for k, p in ((old_k, po), (K, pn_))]
        var_jobs = {name: pool.submit(K._build_library, ("bitplane_pack.cu",), (K.QPACK,),
                                      K.HEADERS, header, d) for name, d in var_dirs.items()}
        for j in jobs:
            j.result()
        var_libs = {name: j.result() for name, j in var_jobs.items()}
    rec = {"ptxas": ptxas_of(K, sorted(set(K.BUILD_LOG) - before), "qpack_kernel")}
    for ln in rec["ptxas"]:
        print(f"ptxas (qpack): {ln}", flush=True)
    # the 16-byte-load instance of every mode and variant, and the old kernel
    rec["sass"] = (sass_counts(K, sorted(set(K.BUILD_LOG) - before), "qpack_kernelILi2E")
                   + sass_counts(old_k, sorted(set(old_k.BUILD_LOG) - before_old),
                                 "qpack_kernel"))
    B, L = chars.shape
    for mode, (po, pn_) in plans.items():
        want = bp.qpack_plain(pn_, chars, len_wb)

        def run_old(po=po):
            return old_k.qpack_cuda(po, chars, len_wb)

        def run_new(pn_=pn_):
            return K.qpack_cuda(pn_, chars, len_wb)

        check(cs, f"qpack {mode} old", run_old(), want)
        check(cs, f"qpack {mode} new", run_new(), want)
        bound = cs.bound(B * L + cs.nbytes(len_wb) + L * (B // 32) * 4 * (pn_.kp + pn_.en_pack),
                         sum(c.class_prog.n_ops for c in pn_.circuits) * L * (B // 32))
        rec[mode] = in_turns(cs, f"qpack {mode} (KP={pn_.kp}, B={B} x L={L}; bound "
                             f"{bound['bound_ms']:.4f} ms by {bound['bound_by']})", run_old,
                             run_new, flush, card)
        rec[mode]["bound_ms"] = bound["bound_ms"]
        del want

    def run_new():
        return K.qpack_cuda(pn, chars, len_wb)

    def with_lib(lib, plan=pn, ch=chars, lw=len_wb, vec=2):
        def go():
            Bc, Lc = ch.shape
            bits = torch.empty((Lc, plan.kp, Bc // 4096, 128), dtype=torch.int32, device=dev)
            en = torch.empty((Bc // 4096, Lc, 128), dtype=torch.int32, device=dev)
            err = lib.h2r_qpack(ch.data_ptr(), lw.data_ptr(), bits.data_ptr(), en.data_ptr(),
                                Bc, Lc, vec, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return bits, en
        return go

    want = bp.qpack_plain(pn, chars, len_wb)
    for name, lib in var_libs.items():
        if name not in QPACK_TIMING_ONLY:
            check(cs, f"qpack variant {name}", with_lib(lib)(), want)
        rec[f"binary_{name}"] = in_turns(
            cs, f"qpack binary: the kernel as old, variant {name} as new", run_new, with_lib(lib),
            flush, card)
    del want
    no_flush = torch.empty(1, dtype=torch.uint8, device=dev)
    t = cs.time_ms(run_new, no_flush, device_only=True)
    rec["binary_no_flush"] = t["median"]
    print(f"qpack binary without the L2 flush: {cs.fmt(t)}; card {card}", flush=True)

    # L=36: 4-byte loads where the rows are 4-byte aligned, else byte loads
    c36, n36 = (torch.from_numpy(a).to(dev) for a in cs.bench_corpus(B, 36))
    lw36 = bp.len_table(n36)
    po36, pn36 = pk.plans(36)
    want = bp.qpack_plain(pn36, c36, lw36)
    by_vec = {v: with_lib(K.build(pn36), pn36, c36, lw36, v) for v in (0, 1)}
    for v, fn in by_vec.items():
        check(cs, f"qpack L=36 vec {v}", fn(), want)
    check(cs, "qpack L=36 old", old_k.qpack_cuda(po36, c36, lw36), want)
    rec["L36"] = in_turns(cs, f"qpack binary at B={B} x L=36", lambda: old_k.qpack_cuda(
        po36, c36, lw36), lambda: K.qpack_cuda(pn36, c36, lw36), flush, card)
    rec["L36_vec1_vs_vec0"] = in_turns(
        cs, f"qpack binary at B={B} x L=36: byte loads (vec 0) as old, 4-byte loads (vec 1) "
        "as new", by_vec[0], by_vec[1], flush, card)
    return rec


def fsm_ab(pk: Pkgs, cs, dev, card, flush, chars, lengths) -> dict:
    """The one-pass FSMs of pallas_from, old (a launch a direction)
    against new (one launch, the codes in shared memory; and in a global
    scratch); each direction alone; the new one against its look-ahead
    variants."""
    K, old_k = pk.K, pk.old_k
    ps = importlib.import_module("halo2_regex_tpu_torch.ops.pallas_scan")
    var_dirs = {name: variant_csrc(K, f"fsm_{name}", edits)
                for name, edits in FSM_VARIANTS.items()}
    before, before_old = set(K.BUILD_LOG), set(old_k.BUILD_LOG)
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(k.build_tables) for k in (K, old_k)]
        var_jobs = {name: pool.submit(K._build_library, ("table_fsm.cu",), (K.TABLE_FSM,), (),
                                      None, d) for name, d in var_dirs.items()}
        for j in jobs:
            j.result()
        var_libs = {name: j.result() for name, j in var_jobs.items()}
    rec = {"ptxas": ptxas_of(K, set(K.BUILD_LOG) - before, "table_fsm_pass_kernel")}
    for ln in rec["ptxas"]:
        print(f"ptxas (table_fsm one pass): {ln}", flush=True)
    rec["sass"] = (sass_counts(K, sorted(set(K.BUILD_LOG) - before), "table_fsm_pass_kernel")
                   + sass_counts(old_k, sorted(set(old_k.BUILD_LOG) - before_old),
                                 "table_fsm_pass_kernel"))
    m = pk.h2r.PallasMatcher(pk.h2r.zoo.email_headers_model(max_chars_size=cs.L,
                                                            headers=("from",)))
    _st, ids, sta, ef, _f, _b = m.run_planes(chars, lengths)
    B, L = chars.shape
    if K.table_fsm_form(B, dev) or old_k.table_fsm_form(B, dev):
        raise AssertionError(f"B={B}: the FSMs no longer take their one-pass form")
    want = (torch.empty_like(_f), torch.empty_like(_b))
    ps.fsm_plain(False, ids, sta, ef, None, None, None, 0, L, want[0])
    ps.fsm_plain(True, ids, sta, ef, None, None, None, 0, L, want[1])
    def with_k(k, dirs=3, lib=None, smem_ls=None):
        """``k``'s one-pass FSMs; ``lib``: a variant's library; ``smem_ls``:
        0 puts the backward codes in the global scratch."""
        def go():
            f = torch.empty_like(want[0]) if dirs & 1 else None
            b = torch.empty_like(want[1]) if dirs & 2 else None
            saved = k.build_tables
            if lib is not None:
                k.build_tables = lambda: lib
            if smem_ls is not None:
                saved_ls, k.TABLE_FSM_SMEM_LS = k.TABLE_FSM_SMEM_LS, smem_ls
            try:
                k.table_fsms_cuda(ids, sta, ef, 0, L, f, b, cl=0)
            finally:
                k.build_tables = saved
                if smem_ls is not None:
                    k.TABLE_FSM_SMEM_LS = saved_ls
            return tuple(x for x in (f, b) if x is not None)
        return go

    def want_of(dirs):
        return tuple(w for i, w in enumerate(want) if dirs >> i & 1)

    run_old, run_new = with_k(old_k), with_k(K)
    runs = {"old": run_old, "new": run_new, "new, global codes": with_k(K, smem_ls=0)}
    runs.update({f"new {n}": with_k(K, lib=lib) for n, lib in var_libs.items()})
    for name, fn in runs.items():
        check(cs, f"table_fsm {name}", fn(), want)
    for d in (1, 2):
        for k in (old_k, K):
            check(cs, f"table_fsm dirs={d}", with_k(k, d)(), want_of(d))
    bound = cs.bound(3 * cs.nbytes(ids) + 2 * L * B * 4, 2 * L * B * (3 * m.n_defs + 6))
    rec["pallas_from"] = in_turns(
        cs, f"table_fsm one pass, pallas_from (B={B} x L={L}; bound {bound['bound_ms']:.4f} ms "
        f"by {bound['bound_by']})", run_old, run_new, flush, card)
    rec["pallas_from"]["bound_ms"] = bound["bound_ms"]
    for name in runs:
        if name != "old" and name != "new":
            rec[f"pallas_from ({name})"] = in_turns(
                cs, f"table_fsm one pass, pallas_from: the kernel as old, {name} as new",
                run_new, runs[name], flush, card)
    for d, what in ((1, "forward"), (2, "backward")):
        rec[f"pallas_from_{what}"] = in_turns(
            cs, f"table_fsm one pass, pallas_from, the {what} FSM alone", with_k(old_k, d),
            with_k(K, d), flush, card)
    return rec


def helpers_ab(pk: Pkgs, cs, dev, card, flush, chars_np, chars, len_wb) -> dict:
    """The kernels that share K1's byte-plane helper, old against new, each
    against its plain version."""
    K, old_k, bp = pk.K, pk.old_k, pk.bp
    B, L = chars.shape
    raw = pk.plans(L, qpack=False)
    tiled = pk.plans(L, tiled=True)
    fpack = pk.plans(L, fuse_pack=True)
    main = pk.plans(L)[1]
    with ThreadPoolExecutor(6) as pool:
        for j in [pool.submit(k.build, p) for pair in (raw, tiled, fpack)
                  for k, p in zip((old_k, K), pair)]:
            j.result()
    quads = bp.raw_quads(chars, L)
    tl = torch.from_numpy(bp.tile_corpus(chars_np, L)).to(dev)
    bits, en = K.qpack_cuda(main, chars, len_wb)
    logs = K.scan_cuda(main, bits)
    cases = {
        "pack_raw": (lambda k, p: k.pack_raw_cuda(p, quads, len_wb), raw,
                     lambda p: bp.pack_plain(p, quads, len_wb)),
        "tpack": (lambda k, p: k.tpack_cuda(p, tl, len_wb), tiled,
                  lambda p: bp.tpack_plain(p, tl, len_wb)),
        "scan_fpack": (lambda k, p: k.scan_fpack_cuda(p, quads), fpack,
                       lambda p: bp.scan_fpack_plain(p, quads)),
        "post_tiled": (lambda k, p: k.post_tiled_cuda(p, logs, en, tl), tiled,
                       lambda p: bp.post_plain(p, logs, en, tl)),
    }
    rec = {}
    for name, (run, (po, pn), plain) in cases.items():
        want = plain(pn)
        check(cs, f"{name} old", run(old_k, po), want)
        check(cs, f"{name} new", run(K, pn), want)
        del want
        rec[name] = in_turns(cs, f"{name} (B={B} x L={L})", lambda r=run, p=po: r(old_k, p),
                             lambda r=run, p=pn: r(K, p), flush, card)
    return rec


def walls_ab(pk: Pkgs, cs, dev, card, flush) -> dict:
    """End-to-end walls, old package against new, in turns, with equal
    outputs."""
    h2r, old, K, old_k = pk.h2r, pk.old, pk.K, pk.old_k
    model3, chars3_np, _ = cs.config3(h2r)
    t3 = (torch.from_numpy(chars3_np).to(dev),
          torch.full((cs.B3,), cs.L3, dtype=torch.int32, device=dev))
    tf = tuple(torch.from_numpy(a).to(dev) for a in cs.bench_corpus(cs.B, cs.L))
    tu = tuple(torch.from_numpy(a).to(dev) for a in cs.bench_corpus(cs.B, cs.L_UNPADDED))
    tiled = torch.from_numpy(pk.bp.tile_corpus(tf[0].cpu().numpy(), cs.L)).to(dev)

    def from_model(p, length=cs.L):
        return p.zoo.email_headers_model(max_chars_size=length, headers=("from",))

    paths = {
        "witness": (lambda p: p.BitplaneMatcher(from_model(p), columns="witness"), tf),
        "witness_direct": (lambda p: p.BitplaneMatcher(from_model(p), columns="witness",
                                                       emit="direct"), tf),
        "match": (lambda p: p.BitplaneMatcher(from_model(p), columns="match"), tf),
        "full": (lambda p: p.BitplaneMatcher(from_model(p)), tf),
        "tiled_witness": (lambda p: p.BitplaneMatcher(from_model(p), columns="witness",
                                                      input_layout="tiled"),
                          (tiled, tf[1])),
        "L1000": (lambda p: p.BitplaneMatcher(from_model(p, cs.L_UNPADDED), columns="witness"),
                  tu),
        "pallas_from": (lambda p: p.PallasMatcher(from_model(p)), tf),
        "pallas_large": (lambda p: p.PallasMatcher(model3, max_pairs=4096), t3),
    }
    built = {name: (make(old), make(h2r)) for name, (make, _io) in paths.items()}
    with ThreadPoolExecutor(8) as pool:  # every library of both packages at once
        jobs = [pool.submit(k.build_tables) for k in (old_k, K)]
        jobs += [pool.submit(k.build, m.plan) for pair in built.values()
                 for m, k in zip(pair, (old_k, K)) if hasattr(m, "plan")]
        for j in jobs:
            j.result()
    out = {}
    for name, (_make, (ch, ln)) in paths.items():
        mo, mn = built[name]
        a, b = mo(ch, ln), mn(ch, ln)
        torch.cuda.synchronize()
        cs.assert_same(f"{name} old vs new", b, a)
        del a, b
        out[name] = in_turns(cs, f"wall {name}", lambda: mo(ch, ln), lambda: mn(ch, ln), flush,
                             card, device_only=False, iters=WALL_ITERS)
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier halo2_regex_tpu_torch/ package")
    ap.add_argument("--only", default="qpack,fsm,helpers,walls",
                    help="comma-separated parts to run (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import kernels as K

    # both packages build into the checkout's build root
    os.environ.setdefault("H2R_TORCH_BUILD_DIR", str(K.build_root()))
    old, old_k = import_old(Path(args.old).resolve())
    pk = Pkgs(h2r, old, K, old_k)
    dev = torch.device("cuda")
    card = cs.smi()
    print(f"card: {card}", flush=True)
    rec: dict = {"card": card, "versions": cs.versions()}
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    chars_np, lengths_np = cs.bench_corpus(cs.B, cs.L)
    chars, lengths = (torch.from_numpy(a).to(dev) for a in (chars_np, lengths_np))
    len_wb = pk.bp.len_table(lengths)
    parts = set(args.only.split(","))
    out = {}
    if "qpack" in parts:
        out["qpack"] = qpack_ab(pk, cs, dev, card, flush, chars, len_wb)
    if "fsm" in parts:
        out["table_fsm"] = fsm_ab(pk, cs, dev, card, flush, chars, lengths)
    if "helpers" in parts:
        out["helpers"] = helpers_ab(pk, cs, dev, card, flush, chars_np, chars, len_wb)
    if "walls" in parts:
        out["walls"] = walls_ab(pk, cs, dev, card, flush)
    rec["ab"] = out
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_ab.json", "w") as f:
        json.dump(rec, f, indent=1)

    def pairs_of(d):  # the medians of every pair in d, nested as in d
        got = {}
        for k, v in d.items():
            if isinstance(v, dict):
                sub = {"old": v["old"], "new": v["new"]} if "new" in v else pairs_of(v)
                if sub:
                    got[k] = sub
        return got

    return {"ok": True, "card": card, "ab": pairs_of(out)}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
