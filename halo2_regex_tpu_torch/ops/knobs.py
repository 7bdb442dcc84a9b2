"""The pipeline knobs of the port's bitplane matcher.

A copy of the JAX package's ``ops/knobs.py`` (which imports no JAX, but
the port imports nothing of that package): every ``H2R_*`` environment
knob the bitplane matcher honors is read here, validated as a set, and
carried as an immutable value.  Constructor arguments override the
environment; the environment overrides the defaults.  The port runs every
value the JAX matcher accepts, and raises the JAX package's ``ValueError``
for every set it refuses.

  H2R_SCAN_UNROLL   int >= 1    unroll of the scan's position loop (the
                                CUDA scans' ``#pragma unroll``; 4 when the
                                caller gives none)
  H2R_FUSE_PACK     0/1         extract the byte planes in the scan
                                (``scan_fpack``) instead of a pack kernel
  H2R_CLASS_STAGE   0/1/onehot/binary  byte->class circuit in the pack
                                kernel (binary or one-hot class planes), or
                                folded into the scan's step circuit (0)
  H2R_EN_PACK       0/1         enable plane computed in the pack kernel
                                (default on; off under fuse_pack), else by
                                torch ops
  H2R_QPACK         0/1         pack from the [B, L] bytes (default on;
                                off under fuse_pack, and per matcher when
                                L != L_pad)
  H2R_EMIT          planes/bytes/direct/kdecode  witness emission tail
  H2R_WITNESS_BYTES legacy 0/1 alias for planes/bytes
  H2R_VMEM_LIMIT    bytes       the TPU's scoped-VMEM ceiling: validated as
                                in JAX, unused by the CUDA kernels
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional, Union

_EMITS = ("planes", "bytes", "direct", "kdecode")


@dataclass(frozen=True)
class BitplaneKnobs:
    """Validated knob set for one BitplaneMatcher construction."""

    unroll: int = 1
    fuse_pack: bool = False
    class_stage: Union[bool, str] = "binary"  # False | "binary" | "onehot"
    en_pack: bool = True
    qpack: bool = True
    emit: Optional[str] = None  # None = mode-dependent default ("bytes")
    vmem_limit: int = 100 * 1024 * 1024

    @classmethod
    def from_env(
        cls,
        *,
        unroll: Optional[int] = None,
        fuse_pack: Optional[bool] = None,
        class_stage: Optional[Union[bool, str]] = None,
        en_pack: Optional[bool] = None,
        qpack: Optional[bool] = None,
        emit: Optional[str] = None,
    ) -> "BitplaneKnobs":
        """Resolve knobs: explicit argument > environment > default.

        Raises ValueError on malformed values or contradictory sets.
        ``class_stage`` is auto-disabled under ``fuse_pack`` only when it
        was not explicitly requested (by argument or environment); an
        explicit conflict is an error, as are explicit ``en_pack`` or
        ``qpack`` under ``fuse_pack``.
        """
        explicit_cs = class_stage is not None
        if unroll is None:
            unroll = int(os.environ.get("H2R_SCAN_UNROLL", 1))
        env_fp = os.environ.get("H2R_FUSE_PACK")
        if fuse_pack is None and env_fp is not None:
            fuse_pack = env_fp != "0"
        if fuse_pack is None:
            fuse_pack = False
        env_cs = os.environ.get("H2R_CLASS_STAGE")
        if class_stage is None and env_cs is not None:
            try:
                class_stage = {
                    "0": False,
                    "false": False,
                    "1": "onehot",
                    "onehot": "onehot",
                    "binary": "binary",
                }[env_cs.lower()]
            except KeyError:
                raise ValueError(
                    f"H2R_CLASS_STAGE={env_cs!r}: expected one of "
                    "0/false/1/onehot/binary"
                ) from None
            explicit_cs = True
        if class_stage is None:
            class_stage = "binary"
        if class_stage is True:
            class_stage = "onehot"
        explicit_en = en_pack is not None or "H2R_EN_PACK" in os.environ
        explicit_qp = qpack is not None or "H2R_QPACK" in os.environ
        if en_pack is None:
            env_en = os.environ.get("H2R_EN_PACK")
            en_pack = env_en == "1" if env_en is not None else True
        if qpack is None:
            env_qp = os.environ.get("H2R_QPACK")
            qpack = env_qp == "1" if env_qp is not None else True
        if emit is None:
            emit = os.environ.get("H2R_EMIT")
            if emit is None:
                wb = os.environ.get("H2R_WITNESS_BYTES")
                if wb is not None:
                    emit = {"0": "planes", "1": "bytes"}.get(wb)
                    if emit is None:
                        raise ValueError(
                            f"H2R_WITNESS_BYTES={wb!r}: expected 0/1"
                        )
        if emit is not None:
            emit = emit.lower()
        vmem_limit = int(os.environ.get("H2R_VMEM_LIMIT", 100 * 1024 * 1024))

        knobs = cls(
            unroll=unroll,
            fuse_pack=fuse_pack,
            class_stage=class_stage,
            en_pack=en_pack,
            qpack=qpack,
            emit=emit,
            vmem_limit=vmem_limit,
        )
        return knobs._validate(
            explicit_cs=explicit_cs,
            explicit_en=explicit_en,
            explicit_qp=explicit_qp,
        )

    def _validate(
        self,
        explicit_cs: bool,
        explicit_en: bool = True,
        explicit_qp: bool = True,
    ) -> "BitplaneKnobs":
        k = self
        if k.unroll < 1:
            raise ValueError(f"unroll={k.unroll}: must be >= 1")
        if k.emit is not None and k.emit not in _EMITS:
            raise ValueError(
                f"H2R_EMIT={k.emit!r}: expected planes/bytes/direct/kdecode"
            )
        if k.vmem_limit <= 0:
            raise ValueError(f"H2R_VMEM_LIMIT={k.vmem_limit}: must be > 0")
        if k.fuse_pack and k.class_stage:
            # fuse_pack extracts the byte planes in the scan, so there is
            # no pack kernel to host the class circuit
            if explicit_cs:
                raise ValueError(
                    "class_stage and fuse_pack are mutually exclusive "
                    "(in-scan plane extraction has no pack kernel for "
                    "the class circuit)"
                )
            k = replace(k, class_stage=False)
        if k.fuse_pack and k.en_pack:
            if explicit_en:
                raise ValueError(
                    "H2R_EN_PACK=1 and H2R_FUSE_PACK=1 conflict: fuse_pack "
                    "removes the pack kernel that would compute the enable "
                    "plane"
                )
            k = replace(k, en_pack=False)
        if k.fuse_pack and k.qpack:
            if explicit_qp:
                raise ValueError(
                    "H2R_QPACK=1 and H2R_FUSE_PACK=1 conflict: qpack is a "
                    "pack-kernel input layout and fuse_pack removes the "
                    "pack kernel"
                )
            k = replace(k, qpack=False)
        return k


def scan_unroll(knobs: BitplaneKnobs, unroll: Optional[int]) -> int:
    """The unroll of the CUDA scans' position loop: the knob's value when
    the caller gives one (argument or ``H2R_SCAN_UNROLL``), else 4, the
    factor measured fastest on the H100 for the from: model.  Any value
    gives the same outputs."""
    if unroll is not None or "H2R_SCAN_UNROLL" in os.environ:
        return knobs.unroll
    return 4
