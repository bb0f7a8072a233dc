"""Timing, roofline accounting and device specs.

The reference has no profiling (SURVEY §5.1: a silent `log` facade and one
CircuitCost print); here throughput measurement and roofline targets are
first-class — BASELINE.md sets the single-device target as a fraction of
the memory-bandwidth roofline.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import jax


# Published peaks per device kind: memory bandwidth in bytes/s, memory in
# bytes, dense compute in FLOP/s.  NVIDIA H200 data sheet (SXM part, at
# its 700 W power limit).  A device that is not listed is an error.
_DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    "NVIDIA H200": {
        "hbm_bytes_per_sec": 4.8e12,
        "hbm_bytes": 141e9,
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
    },
}


def device_specs(device=None) -> Dict[str, float]:
    """Published peaks of ``device`` (default: the first device), keyed by
    its ``device_kind``.  Raises for a kind the table does not list."""
    d = device if device is not None else jax.devices()[0]
    kind = str(d.device_kind)
    if kind not in _DEVICE_SPECS:
        raise KeyError(
            f"no published specs for device kind {kind!r}; "
            f"known: {sorted(_DEVICE_SPECS)}"
        )
    return dict(_DEVICE_SPECS[kind], kind=kind)


@dataclass
class ScanTraffic:
    """Minimum device-memory traffic per input byte for the fused witness
    scan.

    A speed-of-light fused kernel reads each input byte once and writes the
    compact witness row for it: masked char (1B) + substr id (1B) + state
    (2B) + packed flags (1B) ≈ 5B out, 1B in. The transition tables stay
    in cache (read once per kernel, amortized to ~0)."""

    bytes_in_per_byte: float = 1.0
    bytes_out_per_byte: float = 5.0

    @property
    def total(self) -> float:
        return self.bytes_in_per_byte + self.bytes_out_per_byte


def scan_roofline_bytes_per_sec(device=None, traffic: Optional[ScanTraffic] = None) -> float:
    """Input-bytes/sec at the memory roofline for the fused witness scan."""
    spec = device_specs(device)
    t = traffic or ScanTraffic()
    return spec["hbm_bytes_per_sec"] / t.total


def result_nbytes(result) -> int:
    """Total bytes of every materialized array in a witness result (the
    emitted witness traffic — BASELINE's witness-rows metric measures this
    against the ScanTraffic model rather than assuming it)."""
    total = 0
    if hasattr(result, "astuple"):
        result = list(result.astuple())
    for leaf in jax.tree.leaves(result):
        n = getattr(leaf, "nbytes", None)
        if n is None:
            import numpy as np

            n = np.asarray(leaf).nbytes
        total += int(n)
    return total


def time_calls(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> List[float]:
    """Seconds of each of ``iters`` warmed calls of ``fn(*args)``, each
    ended by ``block_until_ready`` on all of its outputs."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    secs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        secs.append(time.perf_counter() - t0)
    return secs


def card_name_and_power_limit() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi`` reports
    them (e.g. "NVIDIA H200, 700.00 W"), or None without nvidia-smi."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info() -> Dict[str, object]:
    """What every benchmark line names: the platform, device kind and
    device count as JAX reports them, and the card's name and power
    limit."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": str(devs[0].device_kind),
        "device_count": len(devs),
        "card": card_name_and_power_limit(),
    }


def require_gpu() -> None:
    """Measurement paths call this first: no GPU is an error, never a
    fallback to the CPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"this measurement needs a GPU; JAX found {platform!r}")
