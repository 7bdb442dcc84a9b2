"""Time the bitplane scan and post kernels against an earlier version of
their sources, on one NVIDIA GPU.

    git archive <commit> halo2_regex_tpu_torch/csrc | tar -x -C build/ab_old
    python3 kernel_ab.py --old build/ab_old/halo2_regex_tpu_torch/csrc

On the zk-email ``from:`` model at bench.py's shape (B=32768 x L=1024,
bench.py's corpus, seed 0) it builds every scan and post mode of the
checkout (the kernels library) and of ``--old`` (a directory holding the
earlier ``csrc/``, built by the same nvcc route into the build root), runs
both on the same inputs, checks that they agree with each other and with
the plain versions, and times each pair in turns, old, new, new, old
(CUDA events, device-only windows, L2 flushed; chip_smoke's ``time_ms``):

  scan (binary class planes; unroll 1, 2, 4, 8), scan_fpack, scan_def (3
  defs of the email model), post in bytes mode (witness and kdecode plans),
  post_tiled, post_planes (full and witness planes plans).

It also times, beside the old scan, a variant of it built from a copy
whose position loop reads its input words from shared memory (loaded once:
its output is not a scan; its time is the circuit's instructions and the stores,
without load waits), and the new post at chunk lengths 8, 16 and 32; and
prints each kernel's registers (ptxas) and the SASS instruction count of
the scan kernels (cuobjdump).  The record goes to
``chiprun_out/kernel_ab.json``; the last line is a JSON summary.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
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


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, help="directory of the earlier csrc/ sources")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import bitplane as bp
    from halo2_regex_tpu_torch.ops import kernels as K
    from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

    old_dir = Path(args.old).resolve()
    dev = torch.device("cuda")
    card = cs.smi()
    print(f"card: {card}", flush=True)
    rec: dict = {"card": card, "versions": cs.versions()}

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
    rec["ptxas"] = regs
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
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
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
    rec["ab"] = out
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_ab.json", "w") as f:
        json.dump(rec, f, indent=1)
    return {"ok": True, "card": card,
            "ab": {k: {"old": v["old"], "new": v["new"]} for k, v in out.items() if "new" in v}}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
