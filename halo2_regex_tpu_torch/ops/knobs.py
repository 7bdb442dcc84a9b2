"""The pipeline knobs the port's bitplane matcher refuses.

The JAX package's ``ops/knobs.py`` resolves the ``H2R_*`` knobs from
arguments and the environment; the port runs the main-path defaults only:

  class_stage = "binary"   byte->class circuit in the pack kernel
  en_pack     = True       enable plane computed in the pack kernel
  qpack       = True       pack reads the [B, L] bytes directly
  emit        = "bytes"    post kernel assembles value bytes
  unroll      = 1, fuse_pack = False

:func:`check_main_path` raises ``NotImplementedError`` naming the
ROADMAP.md item that will port any other value, so a setting is never
silently ignored.
"""

from __future__ import annotations

import os

# knob: (main-path value, {environment variable: its main-path spelling},
# ROADMAP.md item that ports the other values)
_MAIN_PATH = {
    "unroll": (1, {"H2R_SCAN_UNROLL": "1"}, "A11 (scan unroll variants)"),
    "fuse_pack": (False, {"H2R_FUSE_PACK": "0"}, "A11 (in-scan plane extraction)"),
    "class_stage": ("binary", {"H2R_CLASS_STAGE": "binary"},
                    "A11 (onehot / off class stage)"),
    "en_pack": (True, {"H2R_EN_PACK": "1"},
                "A11 (enable plane outside the pack kernel)"),
    "qpack": (True, {"H2R_QPACK": "1"}, "A5 (the raw-quads pack kernel B5)"),
    "emit": ("bytes", {"H2R_EMIT": "bytes", "H2R_WITNESS_BYTES": "1"},
             "A11 (planes / direct / kdecode emission)"),
}


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
