"""Time the port's kernels against an earlier version of the package, on
one NVIDIA GPU.

    git archive <commit> halo2_regex_tpu_torch | tar -x -C build/ab_old
    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch

``--old`` is a directory holding the earlier ``halo2_regex_tpu_torch/``;
its ``csrc/`` is built by the same nvcc route into the build root, and the
package itself is imported as ``h2r_old`` for the end-to-end walls.  Every
pair runs on the same inputs, is checked equal (and, where it is run, to
the plain version), and is timed in turns, old, new, new, old (CUDA events,
L2 flushed; chip_smoke's ``time_ms``: device-only windows for kernels, a
caller's window for walls).

Table kernels (always): the split matcher's scan and both mask FSMs as one
call runs them -- the old ones window by window as the earlier
``run_planes`` launched them, the new ones once over [0, L) -- at
BASELINE configs[3] (B=64 x L=65536, 16 windows of 4096 for the old), and
on the from: model at B=32768 and B=4096 (bench.py's corpus); the
one-pass FSMs at B=32768 built with load batches of 8, 16 and 32
positions and with PR 6's static shared arrays, the chunked FSMs there,
and both one-pass kernels' SASS (``chiprun_out/fsm_pass_sass_*.txt``);
the new scan's chunk length C x warm-up W sweep at configs[3] (C in 512,
1024, 2048, 4096; W in 0, 1024, 2048, 4096, 6144, 8192: each equal to
the serial form, with its repaired positions); a profile of the new
configs[3] scan and FSMs by kernel; and the walls of pallas_large,
pallas_from (B=32768, 4096), pallas_dict (monolithic and split) and the
witness, match and full bitplane paths, old package against new.

Bitplane kernels (when ``--old``'s scan or post source differs from the
checkout's), on the zk-email ``from:`` model at bench.py's shape (B=32768
x L=1024): scan (binary class planes; unroll 1, 2, 4, 8), scan_fpack,
scan_def (3 defs of the email model), post in bytes mode (witness and
kdecode plans), post_tiled, post_planes (full and witness planes plans);
beside the old scan a variant of it whose position loop reads its input
words from shared memory (its output is not a scan; its time is the
circuit's instructions and the stores, without load waits); the new post
at chunk lengths 8, 16 and 32; each kernel's registers (ptxas) and the
SASS instruction count of the scan kernels (cuobjdump).

The record goes to ``chiprun_out/kernel_ab.json``; the last line is a
JSON summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

B, L = 32768, 1024
ROOT = Path(__file__).resolve().parent


def sass_count(so: str, kernel: str) -> int:
    """SASS instructions of the kernel whose mangled name contains
    ``kernel`` in the library ``so``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    n, inside = 0, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"/\*[0-9a-f]{4}\*/", line):
            n += 1
    return n


def variant_times(var, old, flush, card) -> dict:
    """The old scan and its shared-memory-input variant in turns (old,
    variant, variant, old), with cycles a position at 1.98 GHz."""
    import chip_smoke as cs

    t = [cs.time_ms(f, flush, device_only=True) for f in (old, var, var, old)]
    cycles = [x["median"] * 1e-3 * 1.98e9 / L for x in t]
    print(f"scan (old) {t[0]['median']:.4f} / {t[3]['median']:.4f} ms vs its shared-memory-"
          f"input variant {t[1]['median']:.4f} / {t[2]['median']:.4f} ms: "
          f"{cycles[0]:.0f} vs {cycles[1]:.0f} cycles a position at 1.98 GHz; card {card}",
          flush=True)
    return {"old": [t[0]["median"], t[3]["median"]], "variant": [t[1]["median"], t[2]["median"]],
            "cycles_per_position_at_1.98GHz": cycles}


def bitplane_ab(h2r, cs, K, bp, BitplaneKnobs, old_dir: Path, dev, card, flush,
                rec) -> dict:
    """The scan and post kernels of the checkout against those of
    ``old_dir`` (module docstring), with the variant and the chunk sweep."""
    model = h2r.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    plans = {
        "witness": bp.make_plan(model, "witness"),
        "kdecode": bp.make_plan(model, "witness", knobs=BitplaneKnobs(emit="kdecode")),
        "tiled": bp.make_plan(model, "witness", tiled=True),
        "full": bp.make_plan(model, "full"),
        "planes": bp.make_plan(model, "witness", knobs=BitplaneKnobs(emit="planes")),
        "fpack": bp.make_plan(model, "witness", knobs=BitplaneKnobs(
            fuse_pack=True, class_stage=False, en_pack=False, qpack=False)),
        **{f"unroll{u}": bp.make_plan(model, "witness", unroll=u) for u in (1, 2, 8)},
    }
    hdr = bp.make_plan(h2r.zoo.email_headers_model(max_chars_size=L), "match")

    # the variant: the old scan's position loop reads shared memory
    var_dir = K.build_root().parent / "ab_variant" / "csrc"
    if var_dir.exists():
        shutil.rmtree(var_dir)
    shutil.copytree(old_dir, var_dir)
    src = (var_dir / "bitplane_scan.cu").read_text()
    load = "nxt[k] = (uint32_t)bits[((size_t)ln * H2R_KIN + k) * NW + w];"
    variant = load in src and "for (int k = 0; k < H2R_KIN; ++k) in[k] =" in src
    if variant:
        src = src.replace(load, "nxt[k] = sh_in[k][threadIdx.x];")
        src = src.replace("  uint32_t in[H2R_KIN];",
                          "  __shared__ uint32_t sh_in[H2R_KIN][THREADS];\n"
                          "  for (int k = 0; k < H2R_KIN; ++k) sh_in[k][threadIdx.x] = "
                          "(uint32_t)bits[(size_t)k * NW + w];\n  uint32_t in[H2R_KIN];")
        (var_dir / "bitplane_scan.cu").write_text(src)
    else:
        print("--old's scan does not load one position ahead: no shared-memory-input "
              "variant", flush=True)

    def build_at(csrc: Path, plan, sources, header=None):
        return K._build_library(sources, (), includes=K.HEADERS,
                                header=header or K.circuits_header(plan), csrc=csrc)

    def def_header(d):
        return K.circuits_header(K.def_plan(hdr, d)).replace(
            "#pragma once\n", f"#pragma once\n#define H2R_SCAN_DEF 1  // def {d} alone\n", 1)

    jobs = {}
    for name, plan in plans.items():
        srcs = ["bitplane_scan.cu"] + ([] if name.startswith("unroll") or name == "fpack"
                                       else ["bitplane_post.cu"])
        jobs[f"old/{name}"] = (old_dir, plan, srcs, None)
    for d in range(hdr.n_defs):
        jobs[f"old/def{d}"] = (old_dir, hdr, ["bitplane_scan.cu"], def_header(d))
    if variant:
        jobs["variant"] = (var_dir, plans["witness"], ["bitplane_scan.cu"], None)
    build_all = [lambda p=p: K.build(p) for p in plans.values()]
    build_all += [lambda d=d: K.build_scan_def(hdr, d) for d in range(hdr.n_defs)]
    with ThreadPoolExecutor(len(jobs) + len(build_all)) as pool:
        old_f = {k: pool.submit(build_at, *v) for k, v in jobs.items()}
        list(pool.map(lambda f: f(), build_all))
        old = {k: f.result() for k, f in old_f.items()}
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in old.values():
        for name in ("h2r_scan", "h2r_scan_fpack", "h2r_scan_def"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [P, P, I, I, P]
    # the posts are compared only against a serial post (one launch, a
    # scratch fwd plane), not against an earlier chunked one
    serial_post = not hasattr(old["old/witness"], "h2r_post_maps")
    if serial_post:
        for k in ("witness", "kdecode"):
            old[f"old/{k}"].h2r_post.argtypes = [P] * 5 + [I, I, P]
        old["old/tiled"].h2r_post_tiled.argtypes = [P] * 6 + [I, I, P]
        for k in ("full", "planes"):
            old[f"old/{k}"].h2r_post_planes.argtypes = [P] * 3 + [I, I, P]
    else:
        print("--old's post is already chunked: the posts are not compared", flush=True)
    regs = [ln.strip() for info in K.BUILD_LOG.values() for ln in str(info["ptxas"]).splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    rec["ptxas_bitplane"] = regs
    for ln in regs:
        print(f"ptxas: {ln}", flush=True)

    # inputs: the new kernels' pack and scan (each held to plain in chip_smoke)
    chars_np, lengths_np = cs.bench_corpus(B, L)
    chars, lengths = torch.from_numpy(chars_np).to(dev), torch.from_numpy(lengths_np).to(dev)
    pw = plans["witness"]
    len_wb = bp.len_table(lengths)
    bits, en = K.qpack_cuda(pw, chars, len_wb)
    logs = K.scan_cuda(pw, bits)
    quads = bp.raw_quads(chars, L)
    tiled = torch.from_numpy(h2r.tile_corpus(chars_np, L)).to(dev)
    bits3 = K.qpack_cuda(hdr, chars, len_wb)[0]
    NW, NWS = B // 32, B // 4096

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_scan(lib, entry, x, sb):
        def go():
            out = torch.empty((NWS, sb, L, 128), dtype=torch.int32, device=dev)
            err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), NW, L, stream())
            assert err == 0, err
            return out
        return go

    def old_post(lib, plan, tiled_in=None):
        def go():
            fwd = torch.empty((NWS, L, 128), dtype=torch.int32, device=dev)
            g4 = torch.empty((NWS, 8 * plan.n_groups, L, 128), dtype=torch.int32, device=dev)
            fb = torch.empty((NWS, plan.n_defs, 8, 128), dtype=torch.int32, device=dev)
            if tiled_in is None:
                err = lib.h2r_post(logs.data_ptr(), en.data_ptr(), fwd.data_ptr(), g4.data_ptr(),
                                   fb.data_ptr(), NW, L, stream())
            else:
                err = lib.h2r_post_tiled(logs.data_ptr(), en.data_ptr(), tiled_in.data_ptr(),
                                         fwd.data_ptr(), g4.data_ptr(), fb.data_ptr(), NW, L,
                                         stream())
            assert err == 0, err
            return g4, fb
        return go

    def old_planes(lib, plan):
        def go():
            out = torch.empty((NWS, plan.p_total, L, 128), dtype=torch.int32, device=dev)
            assert lib.h2r_post_planes(logs.data_ptr(), en.data_ptr(), out.data_ptr(), NW, L,
                                       stream()) == 0
            return out
        return go

    sb3 = [c.sb for c in hdr.circuits]
    pairs = {
        "scan": (old_scan(old["old/witness"], "h2r_scan", bits, pw.sb_sum),
                 lambda: K.scan_cuda(pw, bits), lambda: None),
        **{f"scan[unroll{u}]": (old_scan(old[f"old/unroll{u}"], "h2r_scan", bits, pw.sb_sum),
                                lambda u=u: K.scan_cuda(plans[f"unroll{u}"], bits), lambda: None)
           for u in (1, 2, 8)},
        "scan_fpack": (old_scan(old["old/fpack"], "h2r_scan_fpack", quads, pw.sb_sum),
                       lambda: K.scan_fpack_cuda(plans["fpack"], quads), lambda: None),
        "scan_def": (lambda: [old_scan(old[f"old/def{d}"], "h2r_scan_def", bits3, sb3[d])()
                              for d in range(hdr.n_defs)],
                     lambda: [K.scan_def_cuda(hdr, bits3, d) for d in range(hdr.n_defs)],
                     lambda: None),
        "post": (old_post(old["old/witness"], pw), lambda: K.post_cuda(pw, logs, en),
                 lambda: bp.post_plain(pw, logs, en)),
        "post[kdecode]": (old_post(old["old/kdecode"], plans["kdecode"]),
                          lambda: K.post_cuda(plans["kdecode"], logs, en),
                          lambda: bp.post_plain(plans["kdecode"], logs, en)),
        "post_tiled": (old_post(old["old/tiled"], plans["tiled"], tiled),
                       lambda: K.post_tiled_cuda(plans["tiled"], logs, en, tiled),
                       lambda: bp.post_plain(plans["tiled"], logs, en, tiled)),
        "post_planes[full]": (old_planes(old["old/full"], plans["full"]),
                              lambda: K.post_planes_cuda(plans["full"], logs, en),
                              lambda: bp.post_planes_plain(plans["full"], logs, en)),
        "post_planes[witness]": (old_planes(old["old/planes"], plans["planes"]),
                                 lambda: K.post_planes_cuda(plans["planes"], logs, en),
                                 lambda: bp.post_planes_plain(plans["planes"], logs, en)),
    }
    if not serial_post:
        pairs = {k: v for k, v in pairs.items() if not k.startswith("post")}
    out = {}
    for name, (run_old, run_new, run_plain) in pairs.items():
        a, b = run_old(), run_new()
        torch.cuda.synchronize()
        err = cs.max_abs_err(b, a)
        want = run_plain()
        if want is not None:
            err = max(err, cs.max_abs_err(b, want))
        if err != 0:
            raise AssertionError(f"{name}: the new kernel disagrees with the old or the plain")
        del a, b, want
        t = [cs.time_ms(f, flush, device_only=True) for f in (run_old, run_new, run_new, run_old)]
        out[name] = {"old": [t[0]["median"], t[3]["median"]],
                     "new": [t[1]["median"], t[2]["median"]], "runs": [x["all"] for x in t]}
        print(f"{name}: old {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, new "
              f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms (old, new, new, old; outputs "
              f"equal, and equal to the plain version where it is run); card {card}",
              flush=True)

    # step 1: the old scan beside its shared-memory-input variant
    so = {"old": old["old/witness"]._name, "new": K.build(pw)._name}
    if variant:
        so["variant"] = old["variant"]._name
        out["scan_vs_smem_input_variant"] = variant_times(
            old_scan(old["variant"], "h2r_scan", bits, pw.sb_sum), pairs["scan"][0], flush, card)
    sass = {k: sass_count(v, "scan_kernel") for k, v in so.items()}
    out["sass_scan_kernel"] = {"instructions": sass, "unroll": pw.unroll,
                               "step_ops": pw.circuits[0].step_ops}
    print(f"SASS instructions of scan_kernel (unroll {pw.unroll}, {pw.circuits[0].step_ops} "
          f"circuit ops a position): {sass}", flush=True)

    # the chunk length of the new post
    saved = K.POST_CL
    ref = K.post_cuda(pw, logs, en)
    sweep = {}
    try:
        for cl in (8, 16, 32):
            K.POST_CL = cl
            got = K.post_cuda(pw, logs, en)
            torch.cuda.synchronize()
            if cs.max_abs_err(got, ref) != 0:
                raise AssertionError(f"post at CL={cl} differs from CL={saved}")
            sweep[cl] = cs.time_ms(lambda: K.post_cuda(pw, logs, en), flush, device_only=True)
            print(f"post at CL={cl}: {cs.fmt(sweep[cl])}; card {card}", flush=True)
    finally:
        K.POST_CL = saved
    out["post_cl_sweep"] = {cl: v["median"] for cl, v in sweep.items()}
    return out


def import_old(old_pkg: Path):
    """The earlier package at ``old_pkg``, imported as ``h2r_old`` (its
    imports are relative, so it loads beside the checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "h2r_old", old_pkg / "__init__.py", submodule_search_locations=[str(old_pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["h2r_old"] = mod
    spec.loader.exec_module(mod)
    return mod, importlib.import_module("h2r_old.ops.kernels")


def in_turns(cs, name, run_old, run_new, flush, card, device_only=True) -> dict:
    """old, new, new, old; prints and returns the medians and every run."""
    t = [cs.time_ms(f, flush, device_only=device_only)
         for f in (run_old, run_new, run_new, run_old)]
    print(f"{name}: old {t[0]['median']:.4f} / {t[3]['median']:.4f} ms, new "
          f"{t[1]['median']:.4f} / {t[2]['median']:.4f} ms (old, new, new, old; outputs equal); "
          f"card {card}", flush=True)
    return {"old": [t[0]["median"], t[3]["median"]], "new": [t[1]["median"], t[2]["median"]],
            "iqr": [x["iqr"] for x in t], "runs": [x["all"] for x in t]}


def table_ab(h2r, cs, K, old_k, dev, card, flush) -> dict:
    """The table scan and FSMs of a call, old (``old_k``: the earlier
    package's kernels module, window by window) against new (one pass), at
    configs[3] and from: B=32768 / 4096; the C x W sweep; a profile."""
    out = {}
    model3, chars3_np, _ = cs.config3(h2r)
    model_f = h2r.zoo.email_headers_model(max_chars_size=cs.L, headers=("from",))
    chars_f_np, lengths_f_np = cs.bench_corpus(cs.B, cs.L)
    chars3 = torch.from_numpy(chars3_np).to(dev)
    lengths3 = torch.full((cs.B3,), cs.L3, dtype=torch.int32, device=dev)
    chars_f = torch.from_numpy(chars_f_np).to(dev)
    lengths_f = torch.from_numpy(lengths_f_np).to(dev)
    m3 = h2r.PallasMatcher(model3, max_pairs=4096)
    mf = h2r.PallasMatcher(model_f)
    def old_scan(m, ch, LS):
        """The earlier _scan_all: one launch a window."""
        def go():
            out_ = torch.empty((m.n_defs, m.L, ch.shape[0]), dtype=torch.int32, device=dev)
            init = m._firsts(ch.shape[0])
            for p0 in range(0, m.L, LS):
                old_k.table_scan_cuda(m.class_map, m.next_table, ch, init, p0, LS, out_)
                init = out_[:, p0 + LS - 1]
            return out_
        return go

    def old_fsms(ids, st, ef, LS):
        """The earlier run_planes' FSM loops: forward ascending and
        backward descending, one launch a window and direction."""
        def go():
            fwd, bwd = torch.empty_like(ids[0]), torch.empty_like(ids[0])
            Ln = ids.shape[1]
            entry = c_ids = c_x = None
            for p0 in range(0, Ln, LS):
                old_k.table_fsm_cuda(False, ids, st, ef, entry, c_ids, c_x, p0, LS, fwd)
                q = p0 + LS - 1
                entry, c_ids, c_x = fwd[q], ids[:, q], ef[:, q]
            entry = c_ids = c_x = None
            for p0 in range(Ln - LS, -1, -LS):
                old_k.table_fsm_cuda(True, ids, st, ef, entry, c_ids, c_x, p0, LS, bwd)
                entry, c_ids, c_x = bwd[p0], ids[:, p0], st[:, p0]
            return fwd, bwd
        return go

    def new_scan(m, ch, form=None):
        def go():
            out_ = torch.empty((m.n_defs, m.L, ch.shape[0]), dtype=torch.int32, device=dev)
            K.table_scan_cuda(m.class_map, m.next_table, ch, m._firsts(ch.shape[0]), 0, m.L,
                              out_, next16=m.next_table16, form=form)
            return out_
        return go

    def new_fsms(ids, st, ef):
        def go():
            fwd, bwd = torch.empty_like(ids[0]), torch.empty_like(ids[0])
            K.table_fsms_cuda(ids, st, ef, 0, ids.shape[1], fwd, bwd)
            return fwd, bwd
        return go

    cases = {"configs3": (m3, chars3, lengths3, m3.window),
             "from_b32768": (mf, chars_f, lengths_f, mf.window),
             "from_b4096": (mf, chars_f[:4096], lengths_f[:4096], mf.window)}
    for name, (m, ch, ln, LS) in cases.items():
        planes = m.run_planes(ch, ln)
        want = m.run_planes(ch, ln, plain=True) if name != "configs3" else None
        st, ids, sta, ef = planes[:4]
        runs = {"scan": (old_scan(m, ch, LS), new_scan(m, ch)),
                "fsm": (old_fsms(ids, sta, ef, LS), new_fsms(ids, sta, ef))}
        res = {"window_old": LS, "form_scan": list(K.table_scan_form(m.n_defs, ch.shape[0],
                                                                     m.L, dev)),
               "form_fsm": K.table_fsm_form(ch.shape[0], dev)}
        for stage, (ro, rn) in runs.items():
            K.reset_launch_counts()
            old_k.reset_launch_counts()
            a, b = ro(), rn()
            torch.cuda.synchronize()
            ref = (st,) if stage == "scan" else planes[4:]
            err = max(cs.max_abs_err(b, a), cs.max_abs_err(b if stage == "fsm" else (b,), ref))
            if want is not None:
                err = max(err, cs.max_abs_err(b if stage == "fsm" else (b,),
                                              (want[0],) if stage == "scan" else want[4:]))
            if err:
                raise AssertionError(f"{name} {stage}: old and new disagree")
            kk = K.TABLE_SCAN if stage == "scan" else K.TABLE_FSM
            res[f"{stage}_launches"] = {"old": getattr(old_k, kk.name.upper()).launches,
                                        "new": kk.launches}
            res[stage] = in_turns(cs, f"{name} {stage} (a call; launches "
                                  f"{res[f'{stage}_launches']})", ro, rn, flush, card)
            del a, b
        both_o = lambda: (runs["scan"][0](), runs["fsm"][0]())  # noqa: E731
        both_n = lambda: (runs["scan"][1](), runs["fsm"][1]())  # noqa: E731
        res["scan+fsm"] = in_turns(cs, f"{name} scan + fsm", both_o, both_n, flush, card)
        out[name] = res
        del planes, want, st, ids, sta, ef

    # the C x W sweep at configs[3], each against the serial form
    ref = new_scan(m3, chars3, (0, 0))()
    sweep = {}
    for C in (512, 1024, 2048, 4096):
        for W in (0, 1024, 2048, 4096, 6144, 8192):
            run = new_scan(m3, chars3, (C, W))
            before = K.table_scan_repaired(dev)
            got = run()
            torch.cuda.synchronize()
            if cs.max_abs_err(got, ref):
                raise AssertionError(f"scan at C={C} W={W} differs from the serial form")
            n_fix = K.table_scan_repaired(dev) - before
            t = cs.time_ms(run, flush, device_only=True)
            sweep[f"C{C}_W{W}"] = {"ms": t["median"], "iqr": t["iqr"], "repaired": n_fix}
            print(f"scan sweep C={C} W={W}: {cs.fmt(t)}, {n_fix} positions repaired; card {card}",
                  flush=True)
    out["scan_sweep_configs3"] = sweep
    # the serial form at configs[3] over the whole L, and the profile of the
    # new scan and FSMs by kernel
    out["scan_serial_configs3"] = cs.time_ms(new_scan(m3, chars3, (0, 0)), flush,
                                             device_only=True)["median"]
    planes3 = m3.run_planes(chars3, lengths3)
    prof = cs.profile_call(lambda: (new_scan(m3, chars3)(), new_fsms(*planes3[1:4])()))
    out["profile_configs3"] = prof
    print(f"configs3 serial-form scan over L: {out['scan_serial_configs3']:.4f} ms; profile of "
          f"the new scan + fsm: busy {prof['busy_ms']:.4f} ms over {prof['n_kernels']:.0f} "
          f"kernels: " + "; ".join(f"{k} {v:.4f}" for k, v in prof["kernels"]), flush=True)
    return out


def fsm_pass_variants(h2r, cs, K, old_k, dev, card, flush) -> dict:
    """The one-pass FSMs (from: B=32768) built with each load batch
    ``kPassStep`` of 8, 16 and 32 positions (copies of the checkout's
    ``csrc/`` with the constant changed), each beside the old kernel in
    turns, with ptxas' registers and spills."""
    src = (K.CSRC / "table_fsm.cu").read_text()
    key = "constexpr int kPassStep = "
    cur = int(src.split(key, 1)[1].split(";", 1)[0])
    m = h2r.PallasMatcher(h2r.zoo.email_headers_model(max_chars_size=cs.L, headers=("from",)))
    ch, ln = (torch.from_numpy(a).to(dev) for a in cs.bench_corpus(cs.B, cs.L))
    _st, ids, sta, ef, fwd, bwd = m.run_planes(ch, ln)
    B = ch.shape[0]
    if K.table_fsm_form(B, dev):
        raise AssertionError("from: at B=32768 no longer takes the one-pass FSMs")

    def old_run():
        f, b = torch.empty_like(fwd), torch.empty_like(bwd)
        old_k.table_fsm_cuda(False, ids, sta, ef, None, None, None, 0, cs.L, f)
        old_k.table_fsm_cuda(True, ids, sta, ef, None, None, None, 0, cs.L, b)
        return f, b

    out = {}
    # the load batches, and the current one with PR 6's static shared
    # arrays (384 bytes: another L1 / shared-memory carveout)
    body = "  const int lane = threadIdx.x, c = threadIdx.y, n_chunks = blockDim.y;"
    smem = ("  __shared__ int pad[3][kLanes];\n  pad[threadIdx.x % 3][threadIdx.x] = 0;\n"
            + body)
    for step in (8, 16, 32, "smem"):
        var_dir = K.build_root().parent / f"ab_fsm_pass{step}" / "csrc"
        if var_dir.exists():
            shutil.rmtree(var_dir)
        shutil.copytree(K.CSRC, var_dir)
        text = (src.replace(body, smem, 1) if step == "smem"
                else src.replace(f"{key}{cur};", f"{key}{step};"))
        if step == "smem" and text == src:
            raise AssertionError("the shared-array variant found no kernel body to change")
        (var_dir / "table_fsm.cu").write_text(text)
        before = set(K.BUILD_LOG)
        lib = K._build_library(K.TABLE_SOURCES, (), csrc=var_dir)
        lib.h2r_table_fsm.argtypes = K._ENTRIES[K.TABLE_FSM]
        ptx = [ln_ for key_ in set(K.BUILD_LOG) - before
               for ln_ in str(K.BUILD_LOG[key_]["ptxas"]).splitlines()]
        at = [i for i, ln_ in enumerate(ptx) if "table_fsm_pass_kernel" in ln_]

        def run(lib=lib):
            f, b = torch.empty_like(fwd), torch.empty_like(bwd)
            err = lib.h2r_table_fsm(3, ids.data_ptr(), sta.data_ptr(), ef.data_ptr(), None, None,
                                    None, 0, None, None, None, 0, f.data_ptr(), b.data_ptr(),
                                    None, 1, B, cs.L, 0, cs.L, 0,
                                    torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return f, b
        got = run()
        torch.cuda.synchronize()
        if cs.max_abs_err(got, (fwd, bwd)):
            raise AssertionError(f"one-pass FSMs with kPassStep={step} disagree")
        out[step] = in_turns(cs, f"from_b32768 one-pass fsm, kPassStep={step} vs the old",
                             old_run, run, flush, card)
        out[step]["ptxas"] = [ln_.strip() for i in at for ln_ in ptx[i + 1: i + 3]]
        print(f"kPassStep={step}: {out[step]['ptxas']}", flush=True)

    def chunked():  # the chunked form where the batch fills the card
        f, b = torch.empty_like(fwd), torch.empty_like(bwd)
        K.table_fsms_cuda(ids, sta, ef, 0, cs.L, f, b, cl=K.TABLE_FSM_CL)
        return f, b
    if cs.max_abs_err(chunked(), (fwd, bwd)):
        raise AssertionError("the chunked FSMs disagree at B=32768")
    out["chunked"] = in_turns(cs, f"from_b32768 chunked fsm (CL={K.TABLE_FSM_CL}) vs the old",
                              old_run, chunked, flush, card)
    # the one-pass kernels' SASS, old and new, for reading offline
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    for tag, lib_, fn in (("old", old_k.build_tables(), "table_fsm_kernel"),
                          ("new", K.build_tables(), "table_fsm_pass_kernel")):
        sass = subprocess.run([cuobjdump, "-sass", lib_._name], capture_output=True,
                              text=True).stdout
        keep, inside = [], False
        for ln_ in sass.splitlines():
            if "Function :" in ln_:
                inside = fn in ln_
            if inside:
                keep.append(ln_)
        (ROOT / "chiprun_out" / f"fsm_pass_sass_{tag}.txt").write_text("\n".join(keep))
        print(f"SASS of the {tag} one-pass FSM kernels: {len(keep)} lines", flush=True)
    return out


def walls_ab(h2r, old, K, old_k, cs, dev, card, flush) -> dict:
    """End-to-end walls, old package against new, in turns, with equal
    outputs: the table paths and the default bitplane paths."""
    model3, chars3_np, _ = cs.config3(h2r)
    model_f = h2r.zoo.email_headers_model(max_chars_size=cs.L, headers=("from",))
    model_d = h2r.zoo.dictionary_model(40, max_chars_size=cs.L)
    chars_f_np, lengths_f_np = cs.bench_corpus(cs.B, cs.L)
    words = [w.encode() for w in
             h2r.zoo.dictionary_config(40)["parts"][1]["regex_def"][1:-1].split("|")]
    chars_d_np, lengths_d_np = cs.dict_corpus(cs.B, cs.L, words)
    t3 = (torch.from_numpy(chars3_np).to(dev), torch.full((cs.B3,), cs.L3, dtype=torch.int32,
                                                          device=dev))
    tf = (torch.from_numpy(chars_f_np).to(dev), torch.from_numpy(lengths_f_np).to(dev))
    td = (torch.from_numpy(chars_d_np).to(dev), torch.from_numpy(lengths_d_np).to(dev))
    t4 = (tf[0][:cs.B_LATENCY], tf[1][:cs.B_LATENCY])
    paths = {
        "pallas_large": (lambda p: p.PallasMatcher(model3, max_pairs=4096), t3),
        "pallas_from": (lambda p: p.PallasMatcher(model_f), tf),
        "pallas_from_b4096": (lambda p: p.PallasMatcher(model_f), t4),
        "pallas_dict": (lambda p: p.PallasMatcher(model_d), td),
        "pallas_dict_split": (lambda p: p.PallasMatcher(model_d, max_pairs=4096), td),
        "witness": (lambda p: p.BitplaneMatcher(model_f, columns="witness"), tf),
        "match": (lambda p: p.BitplaneMatcher(model_f, columns="match"), tf),
        "full": (lambda p: p.BitplaneMatcher(model_f), tf),
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
                             card, device_only=False)
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier halo2_regex_tpu_torch/ package")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import bitplane as bp
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

    old_pkg = Path(args.old).resolve()
    old_csrc = old_pkg / "csrc"
    # both packages build into the checkout's build root
    os.environ.setdefault("H2R_TORCH_BUILD_DIR", str(K.build_root()))
    old, old_k = import_old(old_pkg)
    dev = torch.device("cuda")
    card = cs.smi()
    print(f"card: {card}", flush=True)
    rec: dict = {"card": card, "versions": cs.versions()}
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    out = {"table": table_ab(h2r, cs, K, old_k, dev, card, flush)}
    rec["ptxas_tables"] = [ln.strip() for info in K.BUILD_LOG.values()
                           for ln in str(info["ptxas"]).splitlines()
                           if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    for ln in rec["ptxas_tables"]:
        print(f"ptxas: {ln}", flush=True)
    out["fsm_pass_variants"] = fsm_pass_variants(h2r, cs, K, old_k, dev, card, flush)
    out["walls"] = walls_ab(h2r, old, K, old_k, cs, dev, card, flush)
    same = all((old_csrc / f).read_bytes() == (K.CSRC / f).read_bytes()
               for f in ("bitplane_scan.cu", "bitplane_post.cu"))
    if same:
        print("--old's bitplane scan and post sources equal the checkout's: not compared",
              flush=True)
    else:
        out["bitplane"] = bitplane_ab(h2r, cs, K, bp, BitplaneKnobs, old_csrc, dev, card, flush,
                                      rec)
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
