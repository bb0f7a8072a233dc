"""Multi-host SPMD corpus-scan launcher.

Run the same command on every host of a cluster (one process per host);
`jax.distributed` wires the hosts together and the global mesh spans
every device:

    python -m halo2_regex_tpu.parallel.launch \
        --model model.npz --corpus 'shard-*.txt' \
        [--coordinator host0:1234 --num-processes N --process-id i]

Each process loads its round-robin share
of the corpus files (utils.io.CorpusLoader process sharding), feeds its
per-host slice of the global data-parallel batch, and the match-count
statistics psum-reduce across the slice; process 0 prints them.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--corpus", nargs="+", required=True)
    ap.add_argument("--batch-per-host", type=int, default=1024)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument(
        "--keep-newline",
        action="store_true",
        help="restore each line's \\n terminator (required for models "
        "whose accept state needs \\r\\n, e.g. the email headers)",
    )
    args = ap.parse_args(argv)

    from .mesh import initialize_distributed

    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax

    from ..models.compiled import CompiledRegexModel
    from ..ops.scan_jax import _match_core, _model_arrays
    from ..utils.io import CorpusLoader
    from ..utils.trace import Counters
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .mesh import DATA_AXIS, make_mesh, replicated

    model = CompiledRegexModel.load(args.model)
    mesh = make_mesh()  # all global devices on the data axis
    arrays = {
        k: jax.device_put(v, replicated(mesh)) for k, v in _model_arrays(model).items()
    }
    n_defs = model.n_defs

    import jax.numpy as jnp
    import numpy as np

    @jax.jit
    def step(chars, lengths, valid):
        out = _match_core(arrays, n_defs, chars, lengths)
        # ``valid`` excludes batch-padding rows (and is the step-count
        # synchronization signal: its global sum is 0 exactly when every
        # process has exhausted its corpus shard).
        return dict(
            n_matched=(out["match_ok"] & valid).sum(),
            bytes_scanned=jnp.where(valid, lengths, 0).sum(),
            n_dead=(out["has_dead"].any(axis=1) & valid).sum(),
            n_valid=valid.sum(),
        )

    paths = sorted(p for pat in args.corpus for p in glob.glob(pat))
    loader = CorpusLoader(
        paths,
        max_len=model.max_chars_size,
        batch_size=args.batch_per_host,
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        keep_newline=args.keep_newline,
    )

    sharding = NamedSharding(mesh, P(DATA_AXIS))
    totals = {"n_matched": 0, "bytes_scanned": 0, "n_dead": 0, "strings": 0}
    t0 = time.time()
    # Every process must execute the SAME number of global steps even
    # when shards are unevenly sized (different per-process batch
    # counts would deadlock the collectives): exhausted processes keep
    # contributing empty batches until the global valid-count hits 0.
    Bh = args.batch_per_host
    Lm = model.max_chars_size
    from ..utils.jobs import _prefetched

    # overlap each host's read+pack with its device step
    it = _prefetched(iter(loader), 2)
    row = np.arange(Bh)
    while True:
        nxt = next(it, None)
        if nxt is None:
            chars = np.zeros((Bh, Lm), np.uint8)
            lengths = np.zeros((Bh,), np.int32)
            n_valid = 0
        else:
            chars, lengths, n_valid = nxt
        valid = row < n_valid
        # each host contributes its local slice of the global batch
        gchars = jax.make_array_from_process_local_data(sharding, chars)
        glens = jax.make_array_from_process_local_data(sharding, lengths)
        gvalid = jax.make_array_from_process_local_data(sharding, valid)
        stats = step(gchars, glens, gvalid)
        gv = int(stats["n_valid"])
        if gv == 0:
            break  # all processes exhausted (real batches have >=1 valid)
        totals["n_matched"] += int(stats["n_matched"])
        totals["bytes_scanned"] += int(stats["bytes_scanned"])
        totals["n_dead"] += int(stats["n_dead"])
        totals["strings"] += gv
    if jax.process_index() == 0:
        dt = time.time() - t0
        totals["wall_seconds"] = round(dt, 3)
        totals["bytes_per_sec"] = (
            round(totals["bytes_scanned"] / dt, 1) if dt else 0.0
        )
        print(json.dumps(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
