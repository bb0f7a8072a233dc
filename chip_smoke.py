#!/usr/bin/env python
"""Quickest proof that the system runs on the GPU: one process, one card.

    python chip_smoke.py                 # the one-card phases below
    python chip_smoke.py --four-cards    # the four-card paths only

Phases (each prints a JSON line; any failure raises and exits non-zero):

  1. device — JAX's first device must be a GPU (no CPU fallback); prints
     the card's name and power limit from nvidia-smi.
  2. cli — the main path through the CLI, in-process: ``compile`` the
     zk-email `from:` config at 1 KB, ``scan --keep-newline
     --print-matches`` a seeded 32768-line corpus, a counting scan of the
     same corpus, ``match`` a few lines and ``handoff`` one email.  The
     printed extractions of a seeded sample of rows must equal the numpy
     oracle's (ops/reference.py).
  3. kernels — the fused kernel (every mode, compiled for the card) vs the
     XLA path on all rows and vs the oracle on sampled rows: the `from:`
     model at 32768 x 1024 (columns full, witness, match) and the
     1000-state random table at 64 x 65536 (full, and the entry-state
     scan).  Every output is an integer and the kernel has no matrix
     product (so no TF32 rounding arises): the tolerance is zero.  Prints
     ``memory_analysis()`` of each compiled step.
  4. timing — median of 10 warmed calls, each ended by block_until_ready,
     for the fused kernel and the XLA path at three shapes.

With ``--four-cards`` only the multi-card paths run, each compared
bit-exactly with the one-card result: ``DistributedMatcher`` over a
4-card data mesh with the kernel per shard at 4 x 32768 x 1024, and
``SpeculativeSeqMatcher`` / ``SeqShardedMatcher`` over seq=4 on the
1000-state model at L=65536; each checks which card holds each shard.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

sys.setrecursionlimit(100_000)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

FROM_B, FROM_L = 32768, 1024
BIG_B, BIG_L = 64, 65536
N_SAMPLE = 256


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def same_result(a, b):
    """Field names whose arrays differ (shape, dtype or any element)."""
    import jax.numpy as jnp

    bad = []
    for k in b.field_names():
        x, y = getattr(a, k), getattr(b, k)
        if x.shape != y.shape or x.dtype != y.dtype or not bool(jnp.array_equal(x, y)):
            bad.append(k)
    return bad


def same_as_oracle(row, oracle):
    """Field names where one row of a result differs from the oracle."""
    return [
        k for k in oracle.field_names()
        if not np.array_equal(
            np.asarray(getattr(row, k)).astype(np.int64),
            np.asarray(getattr(oracle, k)).astype(np.int64),
        )
    ]


def memory_line(label, jitted, *args):
    m = jitted.lower(*args).compile().memory_analysis()
    emit("memory_analysis", step=label, argument_bytes=m.argument_size_in_bytes,
         output_bytes=m.output_size_in_bytes, temp_bytes=m.temp_size_in_bytes,
         code_bytes=m.generated_code_size_in_bytes)


# ------------------------------------------------------------------ phases
def phase_device():
    import jax

    from halo2_regex_tpu.utils.profiling import card_name_and_power_limit

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"first device is {dev.platform!r}, not a GPU")
    card = card_name_and_power_limit()
    check(card is not None, "nvidia-smi gave no card name and power limit")
    print(card, flush=True)
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), card=card)
    return card


def phase_cli(out_dir, models):
    from halo2_regex_tpu import cli
    from halo2_regex_tpu.models import zoo
    from halo2_regex_tpu.ops.reference import extract_substrings, match_substrs
    from halo2_regex_tpu.utils.corpus import email_lines

    t0 = time.time()
    cfg = os.path.join(out_dir, "from.json")
    with open(cfg, "w") as f:
        json.dump(zoo.from_header_config(FROM_L), f)
    model_path = os.path.join(out_dir, "from.npz")

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        check(rc == 0, f"cli {argv[0]} exited {rc}")
        return buf.getvalue().splitlines()

    run("compile", cfg, "--max-chars-size", str(FROM_L), "-o", model_path)
    from halo2_regex_tpu.models.compiled import CompiledRegexModel

    model = CompiledRegexModel.load(model_path)
    models["from"] = model

    lines = email_lines(FROM_B, seed=0)
    corpus = os.path.join(out_dir, "corpus.txt")
    with open(corpus, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    printed = run("scan", "--model", model_path, "--keep-newline",
                  "--print-matches", "--batch", "4096", corpus)
    counters = json.loads(printed[-1])
    extractions = {}
    for line in printed[:-1]:
        rec = json.loads(line)
        extractions[rec["input"]] = [
            (s["offset"], s["text"], s["substr_id"]) for s in rec["substrings"]
        ]
    counting = json.loads(run("scan", "--model", model_path, "--keep-newline",
                              "--batch", "4096", corpus)[-1])
    check(counters["strings"] == FROM_B, f"scanned {counters['strings']} lines")
    check(counters["bytes_scanned"] == sum(min(len(s) + 1, FROM_L) for s in lines),
          "bytes_scanned differs from the corpus")
    check(counters["matched"] == len(printed) - 1 > 0,
          "matched count differs from the printed matches")
    for k in ("strings", "bytes_scanned", "matched", "failed", "dead"):
        check(counting[k] == counters[k], f"counting scan {k} differs")

    rng = np.random.default_rng(1)
    sample = rng.choice(FROM_B, size=N_SAMPLE, replace=False)
    n_match = 0
    for i in sample:
        s = (lines[i] + b"\n")[:FROM_L]
        oracle = match_substrs(model.regex_defs, s, FROM_L)
        key = s.decode("latin-1")
        if bool(oracle.match_ok):
            n_match += 1
            check(extractions.get(key) == extract_substrings(oracle),
                  f"row {i}: extraction differs from the oracle")
        else:
            check(key not in extractions, f"row {i}: oracle rejects, scan matched")

    matched = run("match", "--model", model_path, "--strict",
                  "from:alice@gmail.com\r\n", "from:Bob X <bob@x.yz>\r\n")
    check([json.loads(m)["status"] for m in matched] == ["MATCH", "MATCH"],
          "match command rejected a valid header")
    handoff = os.path.join(out_dir, "handoff.txt")
    run("handoff", "--model", model_path, "--output", handoff,
        "from:carol.d@sub.domain-x.org\r\n")
    emit("cli", ok=True, counters=counters, sampled_rows=int(len(sample)),
         sampled_matches=n_match, seconds=time.time() - t0)


def phase_kernels(models, data):
    import jax
    import jax.numpy as jnp

    from halo2_regex_tpu.models import zoo
    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.ops.reference import match_substrs
    from halo2_regex_tpu.ops.scan_jax import BatchMatcher
    from halo2_regex_tpu.utils.corpus import email_corpus
    from halo2_regex_tpu.witness.expand import expand_witness

    t0 = time.time()
    model = models["from"]
    chars, lengths = email_corpus(FROM_B, FROM_L, seed=0)
    c, ln = jnp.asarray(chars), jnp.asarray(lengths)
    data["from"] = (c, ln)
    xla = BatchMatcher(model)
    ref = xla(c, ln)
    sample = np.random.default_rng(2).choice(FROM_B, size=N_SAMPLE, replace=False)
    oracles = {
        int(i): match_substrs(model.regex_defs, chars[i, : lengths[i]].tobytes(), FROM_L)
        for i in sample
    }

    full, name = best_matcher(model, columns="full")
    check(name == "gpu", f"best_matcher chose {name!r} on the GPU")
    memory_line(f"from full {FROM_B}x{FROM_L}", full._run, c, ln)
    out = full(c, ln)
    bad = same_result(out, ref)
    check(not bad, f"from full vs XLA: {bad}")
    host = out.map(np.asarray)
    for i, o in oracles.items():
        bad = same_as_oracle(host.map(lambda a, i=i: a[i]), o)
        check(not bad, f"from full row {i} vs oracle: {bad}")
    emit("kernel", model="from", columns="full", shape=[FROM_B, FROM_L],
         vs_xla_rows=FROM_B, vs_oracle_rows=len(oracles), tolerance=0, ok=True)

    wit, _ = best_matcher(model, columns="witness")
    memory_line(f"from witness {FROM_B}x{FROM_L}", wit._run, c, ln)
    w = wit(c, ln)
    flags = w["flags"].astype(jnp.int32)
    pairs = {
        "states": (w["states"], ref.states),
        "all_substr_ids": (w["all_substr_ids"], ref.all_substr_ids),
        "masked_characters": (w["masked_characters"], ref.masked_characters),
        "mask": (flags & 1, ref.mask),
        "fwd_mask": ((flags >> 1) & 1, ref.fwd_mask),
        "bwd_mask": ((flags >> 2) & 1, ref.bwd_mask),
        "all_enable_flags": ((flags >> 3) & 1, ref.all_enable_flags),
        "accepted": (w["accepted"], ref.accepted),
        "has_dead": (w["has_dead"], ref.has_dead),
        "match_ok": (w["match_ok"], ref.match_ok),
    }
    bad = [k for k, (a, b) in pairs.items()
           if not bool(jnp.array_equal(a.astype(jnp.int32), b.astype(jnp.int32)))]
    check(not bad, f"from witness vs XLA: {bad}")
    rows = np.asarray(sorted(oracles))
    w_rows = {k: np.asarray(v)[rows] for k, v in w.items()}
    expanded = expand_witness(model, w_rows, chars[rows])
    for j, i in enumerate(rows):
        bad = same_as_oracle(expanded.map(lambda a, j=j: a[j]), oracles[int(i)])
        check(not bad, f"from witness row {i} (expanded) vs oracle: {bad}")
    emit("kernel", model="from", columns="witness", shape=[FROM_B, FROM_L],
         vs_xla_rows=FROM_B, vs_oracle_rows=len(oracles), tolerance=0, ok=True)

    mt, _ = best_matcher(model, columns="match")
    memory_line(f"from match {FROM_B}x{FROM_L}", mt._run, c, ln)
    m = mt(c, ln)
    for k in ("accepted", "has_dead", "match_ok"):
        check(bool(jnp.array_equal(m[k], getattr(ref, k))), f"from match {k} vs XLA")
    emit("kernel", model="from", columns="match", shape=[FROM_B, FROM_L],
         vs_xla_rows=FROM_B, tolerance=0, ok=True)

    big = zoo.random_table_model(1000, BIG_L, seed=0)
    models["big"] = big
    rng = np.random.default_rng(3)
    bchars = rng.integers(32, 127, size=(BIG_B, BIG_L)).astype(np.uint8)
    blens = rng.integers(BIG_L // 2, BIG_L + 1, size=(BIG_B,)).astype(np.int32)
    blens[:2] = (BIG_L, 0)
    bc, bl = jnp.asarray(bchars), jnp.asarray(blens)
    data["big"] = (bc, bl)
    bx = BatchMatcher(big)
    bref = bx(bc, bl)
    bk, name = best_matcher(big)
    check(name == "gpu", f"best_matcher chose {name!r} for the 1000-state model")
    memory_line(f"1000-state full {BIG_B}x{BIG_L}", bk._run, bc, bl)
    bout = bk(bc, bl)
    bad = same_result(bout, bref)
    check(not bad, f"1000-state vs XLA: {bad}")
    bhost = bout.map(np.asarray)
    for i in (0, 2):
        o = match_substrs(big.regex_defs, bchars[i, : blens[i]].tobytes(), BIG_L)
        bad = same_as_oracle(bhost.map(lambda a, i=i: a[i]), o)
        check(not bad, f"1000-state row {i} vs oracle: {bad}")
    full_lens = jnp.full((BIG_B,), BIG_L, jnp.int32)
    xfull = bx(bc, full_lens).states[:, :, 1:]
    entries = jnp.broadcast_to(jnp.asarray(big.first_states)[:, None], (1, BIG_B))
    scan_from = jax.jit(bk.scan_from)
    memory_line(f"1000-state entry-state scan {BIG_B}x{BIG_L}", scan_from, bc, entries)
    after = scan_from(bc, entries).transpose(1, 0, 2)
    check(bool(jnp.array_equal(after, xfull)), "entry-state scan vs XLA states")
    emit("kernel", model="random_table_1000", columns="full+entry_state_scan",
         shape=[BIG_B, BIG_L], vs_xla_rows=BIG_B, vs_oracle_rows=2,
         tolerance=0, ok=True, seconds=time.time() - t0)


def phase_timing(models, data, card):
    import jax.numpy as jnp

    from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher
    from halo2_regex_tpu.ops.scan_jax import BatchMatcher
    from halo2_regex_tpu.utils.profiling import time_calls

    c, ln = data["from"]
    bc, bl = data["big"]
    shapes = [
        ("from", FROM_B, FROM_L, c, ln),
        ("from", 4096, FROM_L, c[:4096], ln[:4096]),
        ("big", BIG_B, BIG_L, bc, bl),
    ]
    for key, B, L, cc, ll in shapes:
        model = models[key]
        row = {"model": "from" if key == "from" else "random_table_1000",
               "shape": [B, L], "card": card, "columns": "full"}
        for name, m in (("gpu_kernel", GpuScanMatcher(model)),
                        ("xla", BatchMatcher(model))):
            secs = time_calls(m._run, jnp.asarray(cc), jnp.asarray(ll), iters=10)
            row[f"{name}_median_ms"] = float(np.median(secs)) * 1e3
            row[f"{name}_samples_ms"] = [s * 1e3 for s in secs]
        row["xla_over_gpu_kernel"] = row["xla_median_ms"] / row["gpu_kernel_median_ms"]
        emit("timing", **row)


def check_placement(arr, mesh_devices, axis, label):
    """Each of the n shards of ``arr`` lives on its own card and holds the
    slice of ``axis`` that the mesh assigns it."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[axis].start or 0)
    devs = [s.device for s in shards]
    check(len(set(devs)) == len(mesh_devices) == len(shards),
          f"{label}: shards on {devs}")
    n = arr.shape[axis] // len(shards)
    for k, s in enumerate(shards):
        check((s.index[axis].start or 0) == k * n, f"{label}: shard {k} index {s.index}")
        check(s.data.devices() == {s.device}, f"{label}: shard {k} data not on its card")
    return [str(d) for d in devs]


def phase_four_cards():
    import jax
    import jax.numpy as jnp

    from halo2_regex_tpu.models import zoo
    from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher
    from halo2_regex_tpu.parallel.data_parallel import DistributedMatcher
    from halo2_regex_tpu.parallel.mesh import make_mesh
    from halo2_regex_tpu.parallel.seq_parallel import (
        SeqShardedMatcher,
        SpeculativeSeqMatcher,
    )
    from halo2_regex_tpu.utils.corpus import email_corpus

    devices = jax.devices()
    check(len(devices) == 4, f"--four-cards needs 4 GPUs, found {len(devices)}")
    t0 = time.time()
    model = zoo.email_headers_model(max_chars_size=FROM_L, headers=("from",))
    chars, lengths = email_corpus(4 * FROM_B, FROM_L, seed=0)
    one = GpuScanMatcher(model)
    ref = one(jax.device_put(chars, devices[0]), jax.device_put(lengths, devices[0]))
    mesh = make_mesh(data=4, seq=1)
    dm = DistributedMatcher(model, mesh, backend="gpu")
    out, stats = dm(chars, lengths)
    bad = same_result(out.map(lambda a: jax.device_put(a, devices[0])), ref)
    check(not bad, f"data-parallel vs one card: {bad}")
    check(int(stats["n_matched"]) == int(np.asarray(ref.match_ok).sum()),
          "data-parallel n_matched")
    placed = check_placement(out.states, devices, 0, "data-parallel states")
    emit("four_cards", leg="data_parallel_gpu_kernel", shape=[4 * FROM_B, FROM_L],
         vs_one_card="bit-exact", shard_devices=placed,
         n_matched=int(stats["n_matched"]), seconds=time.time() - t0)

    t0 = time.time()
    big = zoo.random_table_model(1000, BIG_L, seed=0)
    rng = np.random.default_rng(3)
    bchars = rng.integers(32, 127, size=(BIG_B, BIG_L)).astype(np.uint8)
    blens = rng.integers(BIG_L // 2, BIG_L + 1, size=(BIG_B,)).astype(np.int32)
    blens[:2] = (BIG_L, 0)
    bref = GpuScanMatcher(big)(jax.device_put(bchars, devices[0]),
                               jax.device_put(blens, devices[0]))
    seq_mesh = make_mesh(data=1, seq=4)
    for name, m in (
        ("speculative_seq_gpu_kernel",
         SpeculativeSeqMatcher(big, seq_mesh, per_shard="gpu")),
        ("seq_sharded_exact", SeqShardedMatcher(big, seq_mesh)),
    ):
        res = m.match(jnp.asarray(bchars), jnp.asarray(blens))
        bad = same_result(res.map(lambda a: jax.device_put(a, devices[0])), bref)
        check(not bad, f"{name} vs one card: {bad}")
        raw = m(jnp.asarray(bchars), jnp.asarray(blens))
        placed = check_placement(raw["states_after"], devices, 2, f"{name} states")
        rounds = raw.get("spec_rounds")
        emit("four_cards", leg=name, shape=[BIG_B, BIG_L], vs_one_card="bit-exact",
             shard_devices=placed,
             spec_rounds=None if rounds is None else int(np.asarray(rounds)[0]),
             seconds=time.time() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    ap.add_argument("--out-dir", default=os.path.join(HERE, "chiprun_out", "chip_smoke"),
                    help="where the CLI phase writes its config, model and corpus")
    args = ap.parse_args(argv)

    import jax

    from halo2_regex_tpu.utils.cache import enable_compilation_cache

    card = phase_device()
    enable_compilation_cache()
    if args.four_cards:
        phase_four_cards()
    else:
        os.makedirs(args.out_dir, exist_ok=True)
        models, data = {}, {}
        phase_cli(args.out_dir, models)
        phase_kernels(models, data)
        phase_timing(models, data, card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
