#!/usr/bin/env python
"""Headline benchmark: fused DFA-scan + witness throughput on one GPU.

Measures the email-header corpus config (BASELINE configs[2]: the zk-email
`from:` model, 1 KB strings) on one device through ``ops.best_matcher``
and prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

``vs_baseline`` is measured throughput divided by the BASELINE.md target
(80% of the single-device memory-bandwidth roofline for the fused witness
scan — the reference publishes no numbers, so the roofline target IS the
baseline, see BASELINE.md).

Timing: the median of warmed calls, each ended by ``block_until_ready``
on every output.  The compact witness columns (states, masked ids, masked
chars, flags, verdicts) are the jit's outputs, so every call materializes
the whole witness.  Exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

sys.setrecursionlimit(100_000)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

# The witness contract (BASELINE ScanTraffic, ~5 B out per input byte):
# per-byte state, masked substr id, masked char, packed flags + the
# per-string match verdicts.
WITNESS_KEYS = (
    "states",
    "all_substr_ids",
    "masked_characters",
    "flags",
    "accepted",
    "has_dead",
    "match_ok",
)


def main() -> int:
    t_start = time.time()
    import jax.numpy as jnp

    from halo2_regex_tpu.models import zoo
    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.utils.cache import enable_compilation_cache
    from halo2_regex_tpu.utils.corpus import email_corpus
    from halo2_regex_tpu.utils.profiling import (
        device_info,
        require_gpu,
        result_nbytes,
        scan_roofline_bytes_per_sec,
        time_calls,
    )

    require_gpu()
    enable_compilation_cache()
    B = int(os.environ.get("H2R_BENCH_BATCH", 32768))
    L = int(os.environ.get("H2R_BENCH_LEN", 1024))
    iters = int(os.environ.get("H2R_BENCH_ITERS", 20))

    model = zoo.email_headers_model(max_chars_size=L, headers=("from",))
    chars, lengths = email_corpus(B, L, seed=0)
    chars_j, lengths_j = jnp.asarray(chars), jnp.asarray(lengths)

    matcher, backend = best_matcher(model, columns="witness")
    secs = time_calls(matcher._run, chars_j, lengths_j, iters=iters)
    sec_med = float(np.median(secs))
    witness_bytes = result_nbytes(
        {k: v for k, v in matcher._run(chars_j, lengths_j).items()
         if k in WITNESS_KEYS}
    )
    full, _ = best_matcher(model, columns="full")
    secs_full = time_calls(full._run, chars_j, lengths_j, iters=iters)
    full_med = float(np.median(secs_full))
    full_bytes = result_nbytes(full._run(chars_j, lengths_j))
    secs_4096 = time_calls(
        matcher._run, chars_j[:4096], lengths_j[:4096], iters=iters
    )

    value = B * L / sec_med
    target = 0.8 * scan_roofline_bytes_per_sec()
    print(json.dumps({
        "metric": "dfa_scan_bytes_per_sec",
        "value": value,
        "unit": "bytes/s",
        "vs_baseline": value / target,
        "estimator": "median_block_until_ready",
        "noise_band_ms": [
            float(np.percentile(secs, 25)) * 1e3,
            float(np.percentile(secs, 75)) * 1e3,
        ],
        "samples_ms": [s * 1e3 for s in secs],
        "backend": backend,
        **device_info(),
        "batch": B,
        "max_chars": L,
        "sec_per_batch": sec_med,
        "witness_bytes_per_sec": witness_bytes / sec_med,
        "witness_bytes_per_input_byte": witness_bytes / (B * L),
        "batch4096_bytes_per_sec": 4096 * L / float(np.median(secs_4096)),
        "full_columns_bytes_per_sec": B * L / full_med,
        "full_columns_bytes_per_input_byte": full_bytes / (B * L),
        "total_runtime_sec": time.time() - t_start,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
