"""Benchmark suite — the five BASELINE.json configs as runnable benchmarks.

    python benchmarks/run_benchmarks.py [--configs 0 1 2 ...] [--quick]

Config 0: regex1 single-def match — byte-exact state sequence check.
Config 1: regex1-3 + substr1-3 combined extraction over padded 1KB strings.
Config 2: email-header corpus, 32768 and 4096 x 1KB, fused scan on one
          device (full columns, compact witness, match-only).
Config 3: large-DFA stress: 1K-state table, 64KB inputs.
Config 4: data-parallel scaling over every visible device (needs more
          than one).

Each benchmark prints one JSON line naming the device (platform, kind,
count, card name and power limit).  Times are medians of warmed calls,
each ended by ``block_until_ready``.  The suite needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.setrecursionlimit(100_000)

import numpy as np  # noqa: E402

_OUT = None  # set by --out: tee every result line to a jsonl artifact
_DEVICE = {}


def _report(name, **kw):
    line = json.dumps({"benchmark": name, **_DEVICE, **kw})
    print(line, flush=True)
    if _OUT is not None:
        _OUT.write(line + "\n")
        _OUT.flush()


def _median_sec(fn, *args, iters=10):
    from halo2_regex_tpu.utils.profiling import time_calls

    return float(np.median(time_calls(fn, *args, iters=iters)))


def bench0(quick):
    """regex1 over an example input: byte-exact state sequence."""
    from fixtures_bench import regex1_model

    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.ops import reference as ref_ops

    model = regex1_model(max_chars_size=128)
    matcher, backend = best_matcher(model)
    s = b"email was meant for @vitalik. Also for pooja."
    res = matcher.match_one(s)
    oracle = ref_ops.match_substrs(model.regex_defs, s, 128)
    exact = bool(
        (np.asarray(res.states) == oracle.states).all()
        and (np.asarray(res.all_substr_ids) == oracle.all_substr_ids).all()
    )
    _report("config0_regex1_exactness", backend=backend, byte_exact=exact,
            match_ok=bool(res.match_ok))


def bench1(quick):
    """Three defs at once (regex1+2+3), 1KB padded strings."""
    import jax.numpy as jnp
    from fixtures_bench import combined_model

    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.utils.profiling import result_nbytes

    model = combined_model(max_chars_size=1024)
    matcher, backend = best_matcher(model)
    B = 64 if quick else 512
    chars = np.zeros((B, 1024), np.uint8)
    base = b"email was meant for @abc. Also for xyz."
    chars[:, : len(base)] = np.frombuffer(base, np.uint8)
    lengths = np.full((B,), len(base), np.int32)
    c, ln = jnp.asarray(chars), jnp.asarray(lengths)
    dt = _median_sec(matcher._run, c, ln)
    nbytes = result_nbytes(matcher._run(c, ln))
    _report(
        "config1_combined_extraction", backend=backend, batch=B,
        bytes_per_sec=B * 1024 / dt,
        witness_bytes_per_input_byte=nbytes / (B * 1024),
        sec_per_batch=dt,
    )


def bench2(quick):
    """Email corpus: the `from:` model over 1KB header blocks."""
    import jax.numpy as jnp

    from halo2_regex_tpu.models import zoo
    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.utils.corpus import email_corpus
    from halo2_regex_tpu.utils.profiling import result_nbytes

    model = zoo.email_headers_model(max_chars_size=1024, headers=("from",))
    chars, lengths = email_corpus(256 if quick else 32768, 1024, seed=0)
    for B in sorted({len(lengths), min(len(lengths), 4096)}):
        c, ln = jnp.asarray(chars[:B]), jnp.asarray(lengths[:B])
        for columns in ("full", "witness", "match"):
            matcher, backend = best_matcher(model, columns=columns)
            dt = _median_sec(matcher._run, c, ln)
            nbytes = result_nbytes(matcher._run(c, ln))
            _report(
                "config2_email_corpus", backend=backend, columns=columns,
                batch=B, bytes_per_sec=B * 1024 / dt,
                output_bytes_per_input_byte=nbytes / (B * 1024),
                sec_per_batch=dt,
            )


def bench3(quick):
    """Large-DFA stress: 1K-state synthetic table, long inputs."""
    import jax.numpy as jnp

    from halo2_regex_tpu.models.zoo import random_table_model
    from halo2_regex_tpu.ops import best_matcher

    L = 8192 if quick else 65536
    model = random_table_model(n_states=1000, max_chars_size=L, seed=0)
    matcher, backend = best_matcher(model)
    B = 4 if quick else 64
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.integers(32, 127, size=(B, L)).astype(np.uint8))
    ln = jnp.full((B,), L, jnp.int32)
    dt = _median_sec(matcher._run, c, ln, iters=5)
    _report(
        "config3_large_dfa_stress", backend=backend, n_states=1000,
        input_len=L, batch=B, bytes_per_sec=B * L / dt, sec_per_batch=dt,
    )


def bench4(quick):
    """Data-parallel scaling: n devices on n shards vs one device on one."""
    import jax
    import jax.numpy as jnp

    from halo2_regex_tpu.models import zoo
    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.parallel.data_parallel import DistributedMatcher
    from halo2_regex_tpu.parallel.mesh import make_mesh
    from halo2_regex_tpu.utils.corpus import email_corpus

    n = len(jax.devices())
    if n == 1:
        _report("config4_scaling", error="needs more than one device")
        return
    model = zoo.email_headers_model(max_chars_size=1024, headers=("from",))
    single, backend = best_matcher(model)
    dm = DistributedMatcher(model, make_mesh(), backend=backend)
    b_shard = 1024 if quick else 32768
    chars, lengths = email_corpus(b_shard * n, 1024, seed=0)
    one = _median_sec(
        single._run, jnp.asarray(chars[:b_shard]), jnp.asarray(lengths[:b_shard])
    )
    multi = _median_sec(dm, chars, lengths)
    _report(
        "config4_scaling", backend=backend, devices=n,
        batch_per_shard=b_shard, single_shard_sec=one, full_mesh_sec=multi,
        efficiency_vs_single_shard=one / multi,
        bytes_per_sec=b_shard * n * 1024 / multi,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*", default=[0, 1, 2, 3, 4])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=str, default=None,
                    help="tee result JSON lines to this .jsonl artifact")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from halo2_regex_tpu.utils.cache import enable_compilation_cache
    from halo2_regex_tpu.utils.profiling import device_info, require_gpu

    require_gpu()
    enable_compilation_cache()
    _DEVICE.update(device_info())
    if args.out:
        global _OUT
        _OUT = open(args.out, "a")
        _OUT.write(json.dumps({
            "benchmark": "_meta",
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "configs": args.configs,
            "quick": bool(args.quick),
            **_DEVICE,
        }) + "\n")
    benches = [bench0, bench1, bench2, bench3, bench4]
    for i in args.configs:
        benches[i](args.quick)


if __name__ == "__main__":
    main()
