"""Device ops of the port: the bitplane matcher (``bitplane``), the
table-driven matcher (``pallas_scan``), the portable scan
(``scan_torch``), their CUDA kernels (``kernels``),
run extraction (``extract``), the knob check and the numpy oracle; and
``best_matcher``, the backend ladder the CLI and ``ScanJob`` callers use."""

from __future__ import annotations

BACKENDS = ("auto", "bitplane", "pallas", "xla")


def best_matcher(model, backend: str = "auto", device="cuda", **kwargs):
    """Return ``(matcher, backend_name)``, the port of the JAX ladder
    (halo2_regex_tpu/ops/__init__.py:11-53).

    ``backend``: "auto" tries the bit-sliced ``BitplaneMatcher``, then the
    table-driven ``PallasMatcher``, then the portable scan
    ``BatchMatcher``, on either device: the JAX ladder on its accelerator,
    of which the card is the counterpart (JAX on a CPU goes straight to
    "xla", a choice about the TPU kernels' slow interpret mode that the
    port's plain versions do not share).  "bitplane", "pallas" or "xla"
    takes that one alone.  A rung that refuses the model in its
    constructor (``ValueError``, ``NotImplementedError``: a field wider
    than the witness emission, a knob the port does not run) passes to the
    next; any other error, such as the ``RuntimeError`` of a missing CUDA
    device or a failed build, propagates.  ``kwargs`` go to the chosen
    matcher's constructor (``PallasMatcher`` takes no ``columns`` and no
    ``compact``, ``BatchMatcher`` none of them, as in JAX)."""
    from .bitplane import BitplaneMatcher
    from .pallas_scan import PallasMatcher
    from .scan_torch import BatchMatcher

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    candidates = BACKENDS[1:] if backend == "auto" else (backend,)
    last: Exception = ValueError("no backend")
    for name in candidates:
        try:
            if name == "bitplane":
                return BitplaneMatcher(model, device=device, **kwargs), name
            if name == "pallas":
                kw = {k: v for k, v in kwargs.items() if k not in ("columns", "compact")}
                return PallasMatcher(model, device=device, **kw), name
            return BatchMatcher(model, device=device), name
        except (ValueError, NotImplementedError) as e:  # the next rung
            last = e
    raise last
