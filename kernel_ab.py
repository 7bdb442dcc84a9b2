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

Kernels:
  post_direct  B3's direct emission on the zk-email ``from:`` model at
            bench.py's shape (B=32768 x L=1024, bench.py's corpus, the
            new package's pack and scan): one call of each package; the
            new one also with its launch C staging 32, 16 and 8 positions
            (copies of ``csrc/`` with ``kDirectStage`` changed) and at
            chunk lengths 16 and 32;
  table_flat  B12 on the 40-word dictionary model at B=32768 x L=1024
            (chip_smoke's dictionary corpus), its table in shared memory
            and read from global memory, and on nine dictionary defs
            (chip_smoke's ``beyond_staging``: two groups of its scan,
            B=32768 x L=64).
ptxas' registers, shared memory and spills of both kernels' entries.

Walls, old package against new, with equal outputs, 30 runs each:
witness_direct and pallas_dict (the paths of the two kernels), and
witness, witness_kdecode, match, full, pallas_from (B=32768) and
pallas_large (BASELINE configs[3]).

The record goes to ``chiprun_out/kernel_ab.json``; the last line is a
JSON summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WALL_ITERS = 30  # the walls move with the host: more runs than a kernel's 10


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


def direct_ab(h2r, old, cs, K, old_k, dev, card, flush) -> dict:
    """post_direct, old against new, the stage and chunk-length variants."""
    from halo2_regex_tpu_torch.ops import bitplane as bp
    from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

    obp = importlib.import_module("h2r_old.ops.bitplane")
    oknobs = importlib.import_module("h2r_old.ops.knobs")
    B, L = cs.B, cs.L
    model = h2r.zoo.email_headers_model(max_chars_size=L, headers=("from",))
    pd = bp.make_plan(model, "witness", knobs=BitplaneKnobs(emit="direct"))
    pd_old = obp.make_plan(old.zoo.email_headers_model(max_chars_size=L, headers=("from",)),
                           "witness", knobs=oknobs.BitplaneKnobs(emit="direct"))
    # the stage variants: launch C staging 32, 16 and 8 positions
    src = (K.CSRC / "bitplane_post.cu").read_text()
    key = "constexpr int kDirectStage = "
    cur = src.split(key, 1)[1].split(";", 1)[0]
    header = K.circuits_header(pd)
    n_planes = int(header.split("#define H2R_DPLANES ", 1)[1].split()[0])
    unit = n_planes * 33 * 4  # bytes a staged position
    budgets = {32: 32 * unit, 16: 16 * unit, 8: 8 * unit}
    var_dirs = {}
    for dp, budget in budgets.items():
        var_dir = K.build_root().parent / f"ab_direct_dp{dp}" / "csrc"
        if var_dir.exists():
            shutil.rmtree(var_dir)
        shutil.copytree(K.CSRC, var_dir)
        text = src.replace(f"{key}{cur};", f"{key}{budget};")
        if text == src and str(budget) != cur:
            raise AssertionError("no kDirectStage to change in csrc/bitplane_post.cu")
        (var_dir / "bitplane_post.cu").write_text(text)
        var_dirs[dp] = var_dir
    before = set(K.BUILD_LOG)
    with ThreadPoolExecutor(len(var_dirs) + 2) as pool:
        jobs = {dp: pool.submit(K._build_library, ("bitplane_post.cu",), (), K.HEADERS, header,
                                d) for dp, d in var_dirs.items()}
        new_j, old_j = pool.submit(K.build, pd), pool.submit(old_k.build, pd_old)
        libs = {dp: j.result() for dp, j in jobs.items()}
        new_j.result()
        old_j.result()
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.h2r_post_maps.argtypes = [P, P, P, I, I, I, P]
        lib.h2r_post_carry.argtypes = [P, I, I, I, P]
        lib.h2r_post_direct.argtypes = [P, P, P, P, I, I, I, P]
    rec = {"ptxas": ptxas_of(K, sorted(set(K.BUILD_LOG) - before), "post_")}
    for ln in rec["ptxas"]:
        print(f"ptxas (post, direct mode): {ln}", flush=True)

    chars, lengths = (torch.from_numpy(a).to(dev) for a in cs.bench_corpus(B, L))
    bits, en = K.qpack_cuda(pd, chars, bp.len_table(lengths))
    logs = K.scan_cuda(pd, bits)
    NW = B // 32

    def with_lib(lib, CL=K.POST_CL):
        def go():
            stream = torch.cuda.current_stream().cuda_stream
            scr = torch.empty((4, -(-L // CL), NW), dtype=torch.int32, device=dev)
            out = torch.empty((len(pd.dfields), 8, B // 4096, 512, L // 4), dtype=torch.int32,
                              device=dev)
            for err in (lib.h2r_post_maps(logs.data_ptr(), en.data_ptr(), scr.data_ptr(), NW, L,
                                          CL, stream),
                        lib.h2r_post_carry(scr.data_ptr(), NW, L, CL, stream),
                        lib.h2r_post_direct(logs.data_ptr(), en.data_ptr(), scr.data_ptr(),
                                            out.data_ptr(), NW, L, CL, stream)):
                assert err == 0, err
            return out
        return go

    def run_old():
        return old_k.post_direct_cuda(pd_old, logs, en)

    def run_new():
        return K.post_direct_cuda(pd, logs, en)

    want = bp.post_direct_plain(pd, logs, en)
    got = {"old": run_old(), "new": run_new()}
    got.update({f"dp{dp}": with_lib(lib)() for dp, lib in libs.items()})
    got.update({f"cl{cl}": with_lib(libs[32], cl)() for cl in (16, 32)})
    torch.cuda.synchronize()
    for name, g in got.items():
        if cs.max_abs_err(g, want):
            raise AssertionError(f"post_direct {name} disagrees with its plain version")
    del got
    rec["post_direct"] = in_turns(cs, "post_direct (B=32768 x L=1024, from:)", run_old, run_new,
                                  flush, card)
    for dp, lib in libs.items():
        rec[f"post_direct_dp{dp}"] = in_turns(
            cs, f"post_direct, launch C staging {dp} positions", run_old, with_lib(lib), flush,
            card)
    for cl in (16, 32):
        t = cs.time_ms(with_lib(libs[32], cl), flush, device_only=True)
        rec[f"post_direct_cl{cl}"] = t["median"]
        print(f"post_direct at CL={cl} (32 staged positions): {cs.fmt(t)}; card {card}",
              flush=True)
    return rec


def flat_ab(h2r, cs, K, old_k, dev, card, flush) -> dict:
    """table_flat, old against new: dict40 at bench shape (table in shared
    and in global memory) and the nine-def model."""
    before = set(K.BUILD_LOG)
    with ThreadPoolExecutor(2) as pool:
        for j in [pool.submit(k.build_tables) for k in (K, old_k)]:
            j.result()
    rec = {"ptxas": ptxas_of(K, set(K.BUILD_LOG) - before, "table_flat_kernel")}
    for ln in rec["ptxas"]:
        print(f"ptxas (table_flat): {ln}", flush=True)
    words = [w.encode() for w in
             h2r.zoo.dictionary_config(40)["parts"][1]["regex_def"][1:-1].split("|")]
    ch, ln = (torch.from_numpy(a).to(dev) for a in cs.dict_corpus(cs.B, cs.L, words))
    cases = {"dict40": (h2r.PallasMatcher(h2r.zoo.dictionary_model(40, max_chars_size=cs.L)),
                        ch, ln)}
    name, m9, ch9, ln9 = cs.beyond_staging(h2r)[1]
    cases[name] = (m9, ch9, ln9)

    @contextlib.contextmanager
    def old_global(on):
        saved = old_k.flat_smem_bytes
        if on:
            old_k.flat_smem_bytes = lambda *a: 0
        try:
            yield
        finally:
            old_k.flat_smem_bytes = saved

    for name, (m, c, n) in cases.items():
        want = m.run_planes(c, n, plain=True)
        args = (m.class_map, m.flat_table, m.first_states, c, n)
        # dict40's table fits shared memory, nine_defs' (234 KiB) does not
        fits = bool(K.flat_smem_bytes(*m.flat_table.shape, K._smem_optin(dev)))
        for smem in ((True, False) if fits else (False,)):
            def run_old(smem=smem):
                outs = [torch.empty_like(t) for t in want]
                with old_global(not smem):
                    old_k.table_flat_cuda(*args, *outs)
                return tuple(outs)

            def run_new(smem=smem):
                outs = [torch.empty_like(t) for t in want]
                K.table_flat_cuda(*args, *outs, table_in_smem=smem)
                return tuple(outs)

            a, b = run_old(), run_new()
            torch.cuda.synchronize()
            if cs.max_abs_err(a, want) or cs.max_abs_err(b, want):
                raise AssertionError(f"table_flat {name}: old or new disagrees with plain")
            del a, b
            where = "shared" if smem else "global"
            rec[f"{name}_{where}"] = in_turns(
                cs, f"table_flat {name} (B={c.shape[0]} x L={c.shape[1]}, table in {where} "
                f"memory)", run_old, run_new, flush, card)
        del want
    return rec


def walls_ab(h2r, old, cs, K, old_k, dev, card, flush) -> dict:
    """End-to-end walls, old package against new, in turns, with equal
    outputs."""
    model3, chars3_np, _ = cs.config3(h2r)
    model_f = h2r.zoo.email_headers_model(max_chars_size=cs.L, headers=("from",))
    model_d = h2r.zoo.dictionary_model(40, max_chars_size=cs.L)
    words = [w.encode() for w in
             h2r.zoo.dictionary_config(40)["parts"][1]["regex_def"][1:-1].split("|")]
    t3 = (torch.from_numpy(chars3_np).to(dev), torch.full((cs.B3,), cs.L3, dtype=torch.int32,
                                                          device=dev))
    tf = tuple(torch.from_numpy(a).to(dev) for a in cs.bench_corpus(cs.B, cs.L))
    td = tuple(torch.from_numpy(a).to(dev) for a in cs.dict_corpus(cs.B, cs.L, words))
    paths = {
        "witness_direct": (lambda p: p.BitplaneMatcher(model_f, columns="witness",
                                                       emit="direct"), tf),
        "pallas_dict": (lambda p: p.PallasMatcher(model_d), td),
        "witness": (lambda p: p.BitplaneMatcher(model_f, columns="witness"), tf),
        "witness_kdecode": (lambda p: p.BitplaneMatcher(model_f, columns="witness",
                                                        emit="kdecode"), tf),
        "match": (lambda p: p.BitplaneMatcher(model_f, columns="match"), tf),
        "full": (lambda p: p.BitplaneMatcher(model_f), tf),
        "pallas_from": (lambda p: p.PallasMatcher(model_f), tf),
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
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import halo2_regex_tpu_torch as h2r
    from halo2_regex_tpu_torch.ops import kernels as K

    # both packages build into the checkout's build root
    os.environ.setdefault("H2R_TORCH_BUILD_DIR", str(K.build_root()))
    old, old_k = import_old(Path(args.old).resolve())
    dev = torch.device("cuda")
    card = cs.smi()
    print(f"card: {card}", flush=True)
    rec: dict = {"card": card, "versions": cs.versions()}
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    out = {"post_direct": direct_ab(h2r, old, cs, K, old_k, dev, card, flush),
           "table_flat": flat_ab(h2r, cs, K, old_k, dev, card, flush),
           "walls": walls_ab(h2r, old, cs, K, old_k, dev, card, flush)}
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
