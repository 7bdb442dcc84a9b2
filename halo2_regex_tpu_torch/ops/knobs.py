"""The pipeline knobs of the port's bitplane matcher.

The JAX package's ``ops/knobs.py`` resolves the ``H2R_*`` knobs from
arguments and the environment.  The port runs:

  qpack       = True/False pack from the [B, L] bytes (K1) or from the raw
                quad rows (the B5 kernel); default True, and any model
                whose L_pad differs from L takes the raw-quads pack anyway
  class_stage = "binary"   byte->class circuit in the pack kernel
  en_pack     = True       enable plane computed in the pack kernel
  emit        = "bytes"    witness post kernel assembles value bytes
  unroll      = 1, fuse_pack = False

:func:`resolve_qpack` and :func:`resolve_emit` resolve ``qpack`` and the
witness emission as the JAX package does.
:func:`check_main_path` raises ``NotImplementedError`` naming the
ROADMAP.md item that will port any other value of the rest, so a setting
is never silently ignored.
"""

from __future__ import annotations

import os
from typing import Optional

# knob: (main-path value, {environment variable: its main-path spelling},
# ROADMAP.md item that ports the other values)
_MAIN_PATH = {
    "unroll": (1, {"H2R_SCAN_UNROLL": "1"}, "A11 (scan unroll variants)"),
    "fuse_pack": (False, {"H2R_FUSE_PACK": "0"}, "A11 (in-scan plane extraction)"),
    "class_stage": ("binary", {"H2R_CLASS_STAGE": "binary"},
                    "A11 (onehot / off class stage)"),
    "en_pack": (True, {"H2R_EN_PACK": "1"},
                "A11 (enable plane outside the pack kernel)"),
    "emit": ("bytes", {"H2R_EMIT": "bytes", "H2R_WITNESS_BYTES": "1"},
             "A11 (planes / direct / kdecode emission)"),
}


def resolve_qpack(qpack: Optional[bool]) -> bool:
    """The argument when given, else ``H2R_QPACK`` (on iff "1"), else on."""
    if qpack is not None:
        return bool(qpack)
    return os.environ.get("H2R_QPACK", "1") == "1"


def resolve_emit(emit: Optional[str], L_pad: int) -> str:
    """The witness emission the JAX matcher resolves: the argument, else
    ``H2R_EMIT``, else ``H2R_WITNESS_BYTES`` (0 planes, 1 bytes), else
    bytes; ``direct`` and ``kdecode`` fall back to bytes when L_pad is not
    a multiple of 4 (halo2_regex_tpu/ops/bitplane.py:726-751)."""
    if emit is None:
        emit = os.environ.get("H2R_EMIT")
    if emit is None:
        emit = {"0": "planes", "1": "bytes"}.get(os.environ.get("H2R_WITNESS_BYTES", "1"))
    emit = (emit or "bytes").lower()
    if emit in ("direct", "kdecode") and L_pad % 4:
        return "bytes"
    return emit


def check_main_path(**given) -> None:
    """Raise unless every knob is the main path's.  A knob given as an
    argument (not None) is checked alone, as it overrides the
    environment; otherwise its environment variables are."""
    for name, (value, env, item) in _MAIN_PATH.items():
        arg = given.pop(name, None)
        if arg is not None:
            bad = [f"{name}={arg!r}"] if arg != value else []
        else:
            bad = [f"{var}={os.environ[var]}" for var, ok in env.items()
                   if os.environ.get(var, ok).lower() != ok]
        if bad:
            raise NotImplementedError(
                f"{', '.join(bad)}: the PyTorch port runs only "
                f"{name}={value!r}; other settings wait for ROADMAP {item}"
            )
    if given:
        raise TypeError(f"unknown knobs: {sorted(given)}")
