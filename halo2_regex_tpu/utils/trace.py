"""Tracing and observability.

The reference's only instrumentation is a silent ``log`` facade and one
CircuitCost print (SURVEY §5.1). Here:

  - :func:`profile` wraps a region with the JAX profiler (writes a
    TensorBoard-compatible trace directory);
  - :func:`annotate` is a ``jax.named_scope`` alias so kernels/phases show
    up named in traces;
  - :class:`Counters` accumulates scan statistics (bytes, matches, dead
    states) across batches for corpus jobs — host-side, cheap.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import jax

logger = logging.getLogger("halo2_regex_tpu")

annotate = jax.named_scope


@contextlib.contextmanager
def profile(trace_dir: Optional[str] = None):
    """Profile the enclosed region. With ``trace_dir`` writes a perfetto/
    TensorBoard trace; otherwise just logs wall time."""
    t0 = time.perf_counter()
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            yield
    else:
        yield
    logger.info("profiled region: %.3fs", time.perf_counter() - t0)


@dataclass
class Counters:
    """Accumulated corpus-scan statistics."""

    batches: int = 0
    strings: int = 0
    bytes_scanned: int = 0
    matched: int = 0
    failed: int = 0
    dead: int = 0
    wall_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def update(self, result, lengths, n_valid: Optional[int] = None) -> None:
        import numpy as np

        # result may be a RegexResult or an emission dict (the gpu
        # backend's columns="witness"/"match" modes)
        get = (
            result.__getitem__ if isinstance(result, dict)
            else lambda k: getattr(result, k)
        )
        ok = np.asarray(get("match_ok"))
        n = int(ok.shape[0]) if n_valid is None else n_valid
        ok = ok[:n]
        self.batches += 1
        self.strings += n
        self.bytes_scanned += int(np.asarray(lengths)[:n].sum())
        self.matched += int(ok.sum())
        self.failed += int((~ok).sum())
        self.dead += int(np.asarray(get("has_dead"))[:n].any(axis=-1).sum())

    def finish(self) -> "Counters":
        if self._t0:
            self.wall_seconds += time.perf_counter() - self._t0
            self._t0 = 0.0
        return self

    def snapshot(self) -> dict:
        """JSON-safe public state (wall time accumulated to now) — the
        checkpoint payload for resumable jobs (utils/jobs.py)."""
        live = time.perf_counter() - self._t0 if self._t0 else 0.0
        return {
            "batches": self.batches,
            "strings": self.strings,
            "bytes_scanned": self.bytes_scanned,
            "matched": self.matched,
            "failed": self.failed,
            "dead": self.dead,
            "wall_seconds": self.wall_seconds + live,
        }

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_scanned / self.wall_seconds if self.wall_seconds else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "batches": self.batches,
                "strings": self.strings,
                "bytes_scanned": self.bytes_scanned,
                "matched": self.matched,
                "failed": self.failed,
                "dead": self.dead,
                "wall_seconds": round(self.wall_seconds, 4),
                "bytes_per_sec": round(self.bytes_per_sec, 1),
            }
        )
