"""CUDA kernels of the bitplane pipeline: circuit codegen, nvcc build,
ctypes binding, launch counters.

The kernels themselves are static templates under ``csrc/``
(``bitplane_pack.cu`` K1, ``bitplane_scan.cu`` K2, ``bitplane_post.cu``
K3).  What they compute per word depends on the model, so this module
emits each def's synthesized class, step and tag circuits as straight-line
``__device__ __forceinline__`` functions into a header,
``h2r_circuits.cuh``, that the templates include.  At first use for a
model the header and the three templates are compiled by nvcc for
``sm_90a`` into one shared library with a plain C interface, under
``<build root>/<hash of sources + header + flags>/``, and loaded with
``ctypes``.  The build root is ``$H2R_TORCH_BUILD_DIR`` when set, else
``build/h2r_torch_kernels/`` in the source checkout when that is
writable, else ``h2r_torch_kernels/`` in the user's cache directory
(``$XDG_CACHE_HOME`` or ``~/.cache``), as for an installed package.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if ``cudaGetLastError`` reports a failed launch,
and adds one to its kernel's ``launches`` count.  Nothing here runs on
the CPU: the plain versions live in :mod:`.bitplane`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from .bitplane import LANE, TILE, BitplanePlan

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("bitplane_pack.cu", "bitplane_scan.cu", "bitplane_post.cu")
HEADERS = ("bitplane_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class CudaKernel:
    """One hand-written kernel: its C entry point, its source and the TPU
    kernel it replaces, and a plain count of launches."""

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        self.name = name
        self.entry = entry
        self.source = source
        self.replaces = replaces
        self.launches = 0


QPACK = CudaKernel(
    "qpack", "h2r_qpack", "halo2_regex_tpu_torch/csrc/bitplane_pack.cu",
    "halo2_regex_tpu/ops/bitplane.py:1138",
)
SCAN = CudaKernel(
    "scan", "h2r_scan", "halo2_regex_tpu_torch/csrc/bitplane_scan.cu",
    "halo2_regex_tpu/ops/bitplane.py:934",
)
POST = CudaKernel(
    "post", "h2r_post", "halo2_regex_tpu_torch/csrc/bitplane_post.cu",
    "halo2_regex_tpu/ops/bitplane.py:1338",
)
KERNELS = (QPACK, SCAN, POST)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Codegen: circuits -> h2r_circuits.cuh
# ---------------------------------------------------------------------------


def _fn(signature: str, body: List[str]) -> List[str]:
    return (
        [f"static __device__ __forceinline__ void {signature} {{"]
        + ["  " + line for line in body]
        + ["}", ""]
    )


def _c_plane_add(a: List[str], b: List[str], n_out: int, tmp) -> Tuple[List[str], List[str]]:
    """C version of ``bitplane.plane_add`` on named words: returns the
    output expressions and the statements that compute them."""
    lines: List[str] = []
    out: List[str] = []
    carry = None
    for j in range(n_out):
        x = a[j] if j < len(a) else None
        y = b[j] if j < len(b) else None
        terms = [t for t in (x, y, carry) if t is not None]
        if not terms:
            out.append("0u")
            continue
        s = terms[0]
        c = None
        for t in terms[1:]:
            nc, ns = tmp(), tmp()
            lines.append(f"const uint32_t {nc} = {s} & {t};")
            lines.append(f"const uint32_t {ns} = {s} ^ {t};")
            s = ns
            if c is None:
                c = nc
            else:
                cc = tmp()
                lines.append(f"const uint32_t {cc} = {c} | {nc};")
                c = cc
        out.append(s)
        carry = c
    return out, lines


def circuits_header(plan: BitplanePlan) -> str:
    """The per-model header the kernel templates include (see
    ``csrc/bitplane_common.cuh`` for the functions it must define)."""
    circ = plan.circuits
    live_off, off = [], 0
    for c in circ:
        live_off.append(off)
        off += len(c.live_states)
    n_live = off
    out = [
        "// Generated by halo2_regex_tpu_torch/ops/kernels.py from the",
        "// synthesized circuits of one model.  Do not edit.",
        "#pragma once",
        "",
        f"#define H2R_NDEFS {plan.n_defs}",
        f"#define H2R_KP {plan.kp}",
        f"#define H2R_SB_SUM {plan.sb_sum}",
        f"#define H2R_NLIVE {n_live}",
        f"#define H2R_NSUM {plan.nsum}",
        f"#define H2R_NGROUPS {plan.n_groups}",
        "",
    ]

    body = []
    for d, c in enumerate(circ):
        body.append(f"{{  // def {d}: {c.class_prog.n_ops} ops")
        body += ["  " + s for s in c.class_prog.to_c(
            {f"byte_bit{j}": f"bb[{j}]" for j in range(8)},
            {n: f"cls[{plan.cls_off[d] + j}]" for j, n in enumerate(c.class_plane_names)},
        )]
        body.append("}")
    out += _fn("h2r_class(const uint32_t* bb, uint32_t* cls)", body)

    body = [
        f"st[{live_off[d] + i}] = {'0xFFFFFFFFu' if s == c.first_state else '0u'};"
        for d, c in enumerate(circ) for i, s in enumerate(c.live_states)
    ]
    out += _fn("h2r_step_init(uint32_t* st)", body)

    body = []
    for d, c in enumerate(circ):
        idx = {s: live_off[d] + i for i, s in enumerate(c.live_states)}
        ins = {n: f"cls[{plan.cls_off[d] + j}]" for j, n in enumerate(c.class_plane_names)}
        ins.update({f"st{s}": f"st[{i}]" for s, i in idx.items()})
        outs = {f"nst{s}": f"st[{i}]" for s, i in idx.items()}
        outs.update({f"log{j}": f"lg[{plan.sb_off[d] + j}]" for j in range(c.sb)})
        body.append(f"{{  // def {d}: {c.step_prog.n_ops} ops")
        body += ["  " + s for s in c.step_prog.to_c(ins, outs)]
        body.append("}")
    out += _fn("h2r_step(const uint32_t* cls, uint32_t* st, uint32_t* lg)", body)

    body = [
        f"lg[{plan.sb_off[d] + j}] = {'0xFFFFFFFFu' if plan.first_bit(d, j) else '0u'};"
        for d, c in enumerate(circ) for j in range(c.sb)
    ]
    out += _fn("h2r_first_log(uint32_t* lg)", body)

    n_tmp = [0]

    def tmp() -> str:
        n_tmp[0] += 1
        return f"s{n_tmp[0]}"

    body = []
    ids_sum: List[str] = []
    for d, c in enumerate(circ):
        idp = [f"id{d}_{j}" for j in range(plan.idb)]
        body.append(f"uint32_t {', '.join(idp)}, st{d}, ef{d};")
        ins = {f"prev{j}": f"prev[{plan.sb_off[d] + j}]" for j in range(c.sb)}
        ins.update({f"next{j}": f"next[{plan.sb_off[d] + j}]" for j in range(c.sb)})
        outs = {f"id{j}": idp[j] for j in range(plan.idb)}
        outs.update(is_start=f"st{d}", is_end=f"ef{d}")
        body.append(f"{{  // def {d}: {c.tag_prog.n_ops} ops")
        body += ["  " + s for s in c.tag_prog.to_c(ins, outs)]
        body.append("}")
        body += [f"{v} &= en;" for v in idp + [f"st{d}", f"ef{d}"]]
        if d == 0:
            ids_sum = idp
            body += ["start_any = st0;", "endf_any = ef0;"]
        else:
            ids_sum, lines = _c_plane_add(ids_sum, idp, plan.idb + d.bit_length() + 1, tmp)
            body += lines
            body += [f"start_any |= st{d};", f"endf_any |= ef{d};"]
    body += [f"ids[{k}] = {v};" for k, v in enumerate(ids_sum)]
    out += _fn(
        "h2r_tag(const uint32_t* prev, const uint32_t* next, uint32_t en, "
        "uint32_t* ids, uint32_t& start_any, uint32_t& endf_any)",
        body,
    )

    avail: Dict[str, List[str]] = {
        "flags": [f"flags[{k}]" for k in range(6)],
        "masked_idsum": [f"midsum[{k}]" for k in range(plan.nsum)],
    }
    for d, c in enumerate(circ):
        avail[f"states{d}"] = [
            f"(lg[{plan.sb_off[d] + j}] & en)"
            + (" | ~en" if (plan.dummy_states[d] >> j) & 1 else "")
            for j in range(c.sb)
        ]
    body = []
    for gi, grp in enumerate(plan.wgroups):
        planes = [p for name, _off, _nb in grp for p in avail[name]]
        planes += ["0u"] * (8 - len(planes))
        body.append(f"{{  // group {gi}: {', '.join(n for n, _o, _b in grp)}")
        body.append(f"  uint32_t p[8] = {{{', '.join(planes)}}};")
        body.append("  h2r_transpose8(p);")
        body.append(f"  for (int b = 0; b < 8; ++b) words[{8 * gi} + b] = p[b];")
        body.append("}")
    out += _fn(
        "h2r_emit(const uint32_t* flags, const uint32_t* midsum, "
        "const uint32_t* lg, uint32_t en, uint32_t* words)",
        body,
    )

    body = []
    for d, c in enumerate(circ):
        for j in range(8):
            if j < c.sb:
                v = f"acc[{plan.sb_off[d] + j}]"
                if plan.first_bit(d, j):
                    v += " | empty"
            else:
                v = "0u"
            body.append(f"fb[{8 * d + j}] = {v};")
    out += _fn("h2r_fb(const uint32_t* acc, uint32_t empty, uint32_t* fb)", body)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}
# plan -> library, so a launch does not regenerate and hash the header
# (milliseconds of host time); plans hash by identity, and an entry goes
# with its plan.
_PLAN_LIBS: "weakref.WeakKeyDictionary[BitplanePlan, ctypes.CDLL]" = (
    weakref.WeakKeyDictionary()
)
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def build_root() -> Path:
    """Where the libraries are built (see the module docstring)."""
    if os.environ.get("H2R_TORCH_BUILD_DIR"):
        return Path(os.environ["H2R_TORCH_BUILD_DIR"])
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").is_file() and os.access(checkout, os.W_OK):
        return checkout / "build" / "h2r_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "h2r_torch_kernels"


def build(plan: BitplanePlan) -> ctypes.CDLL:
    """Build (once per model and source state) and load the kernels'
    shared library.  A failed build raises with nvcc's output."""
    hit = _PLAN_LIBS.get(plan)
    if hit is not None:
        return hit
    header = circuits_header(plan)
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    lib = _LIBS.get(key)
    if lib is not None:
        _PLAN_LIBS[plan] = lib
        return lib
    out_dir = build_root() / key
    so = out_dir / "libh2r_bitplane.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "h2r_circuits.cuh").write_text(header)
        tmp = out_dir / f"libh2r_bitplane.{os.getpid()}.so"
        cmd = [
            _nvcc(), *NVCC_FLAGS, f"-I{CSRC}", f"-I{out_dir}", "-o", str(tmp),
            *[str(CSRC / s) for s in SOURCES],
        ]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        (out_dir / "build.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {out_dir}:\n"
                f"{' '.join(cmd)}\n{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: a reader never sees a partial library
        BUILD_LOG[key] = {"seconds": secs, "dir": str(out_dir),
                          "ptxas": res.stderr}
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.h2r_qpack.argtypes = [P, P, P, P, I, I, I, P]
    lib.h2r_scan.argtypes = [P, P, I, I, P]
    lib.h2r_post.argtypes = [P, P, P, P, P, I, I, P]
    for fn in (lib.h2r_qpack, lib.h2r_scan, lib.h2r_post):
        fn.restype = I
    _LIBS[key] = lib
    _PLAN_LIBS[plan] = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(kernel: CudaKernel, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel.entry}: launch failed, cudaError {err}")
    kernel.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def qpack_cuda(plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor):
    """K1 (``csrc/bitplane_pack.cu``): same contract as ``qpack_plain``."""
    B, L = chars.shape
    if B % TILE or L != plan.L:
        raise ValueError(f"chars {tuple(chars.shape)}: need B % {TILE} == 0 and L == {plan.L}")
    NWS = B // TILE
    _check(chars, "chars", torch.uint8, (B, L))
    _check(len_wb, "len_wb", torch.int32, (NWS, LANE, 32))
    lib = build(plan)
    with torch.cuda.device(chars.device):
        bits = torch.empty((L, plan.kp, NWS, LANE), dtype=torch.int32, device=chars.device)
        en = torch.empty((NWS, L, LANE), dtype=torch.int32, device=chars.device)
        vec = int(L % 4 == 0 and chars.data_ptr() % 4 == 0)  # 32-bit loads
        _launch(QPACK, lib.h2r_qpack, chars.data_ptr(), len_wb.data_ptr(),
                bits.data_ptr(), en.data_ptr(), B, L, vec, _stream(chars))
    return bits, en


def scan_cuda(plan: BitplanePlan, bits_stack: torch.Tensor) -> torch.Tensor:
    """K2 (``csrc/bitplane_scan.cu``): same contract as ``scan_plain``."""
    L, KP, NWS, _lane = bits_stack.shape
    _check(bits_stack, "bits_stack", torch.int32, (plan.L, plan.kp, NWS, LANE))
    lib = build(plan)
    with torch.cuda.device(bits_stack.device):
        logs = torch.empty((NWS, plan.sb_sum, L, LANE), dtype=torch.int32,
                           device=bits_stack.device)
        _launch(SCAN, lib.h2r_scan, bits_stack.data_ptr(), logs.data_ptr(),
                NWS * LANE, L, _stream(bits_stack))
    return logs


def post_cuda(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor):
    """K3 (``csrc/bitplane_post.cu``): same contract as ``post_plain``."""
    NWS, _sb, L, _lane = logs.shape
    _check(logs, "logs", torch.int32, (NWS, plan.sb_sum, plan.L, LANE))
    _check(en, "en", torch.int32, (NWS, plan.L, LANE))
    lib = build(plan)
    dev = logs.device
    with torch.cuda.device(dev):
        fwd = torch.empty((NWS, L, LANE), dtype=torch.int32, device=dev)
        g4 = torch.empty((NWS, 8 * plan.n_groups, L, LANE), dtype=torch.int32, device=dev)
        fb = torch.empty((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=dev)
        _launch(POST, lib.h2r_post, logs.data_ptr(), en.data_ptr(), fwd.data_ptr(),
                g4.data_ptr(), fb.data_ptr(), NWS * LANE, L, _stream(logs))
    return g4, fb
