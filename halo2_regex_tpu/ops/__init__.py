"""Scan backends.

``best_matcher`` picks a backend from what it can observe — the platform
and whether the model fits the fused kernel's packed table:

  ``gpu`` — :class:`.gpu_scan.GpuScanMatcher`, the fused scan kernel
            (Pallas, Triton route); chosen on a GPU;
  ``xla`` — :class:`.scan_jax.BatchMatcher`, the portable ``lax.scan``
            path; chosen on every other platform, and on a GPU for a
            model the packed table cannot hold.
"""

from __future__ import annotations

BACKENDS = ("auto", "gpu", "xla")


def best_matcher(model, backend: str = "auto", columns: str = "full",
                 interpret: bool = False):
    """Return ``(matcher, backend_name)``.

    ``backend``: "auto" | "gpu" | "xla".  An explicit "gpu" on another
    platform raises unless ``interpret=True`` (tests: the kernel runs
    through the Pallas interpreter), and raises for a model that does not
    fit the packed table.  ``columns`` ("full" | "witness" | "match")
    selects the kernel's outputs; the xla backend always returns the full
    column set, which carries every verdict, and refuses "witness".
    """
    import jax

    from .gpu_scan import GpuScanMatcher, table_fit
    from .scan_jax import BatchMatcher

    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "auto":
        on_gpu = jax.devices()[0].platform == "gpu"
        backend = "gpu" if on_gpu and table_fit(model) is None else "xla"
    if backend == "gpu":
        reason = table_fit(model)
        if reason is not None:
            raise ValueError(f"backend='gpu': {reason}")
        return GpuScanMatcher(model, columns=columns, interpret=interpret), "gpu"
    if columns == "witness":
        raise ValueError(
            "backend='xla' emits the full column set only; "
            "columns='witness' needs backend='gpu'"
        )
    return BatchMatcher(model), "xla"
