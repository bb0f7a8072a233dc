"""Production-shaped example: stream an email corpus, extract addresses.

The serving flow: compile the `from:` header model once, stream a
newline-delimited corpus in fixed batches with a resumable checkpoint,
and pull matched addresses off the device as compact (offset, length,
id, bytes) records via the extraction sink — only matches leave the
chip, not full [B, L] masks.

Run:  python examples/corpus_scan.py
(on a GPU host best_matcher takes the fused kernel; elsewhere the XLA
scan)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.setrecursionlimit(100_000)

import numpy as np

from halo2_regex_tpu.models import zoo
from halo2_regex_tpu.ops import best_matcher
from halo2_regex_tpu.ops.extract import extract_runs
from halo2_regex_tpu.utils.jobs import ScanJob


def main() -> int:
    model = zoo.email_headers_model(max_chars_size=128, headers=("from",))
    matcher, backend = best_matcher(model)
    print(f"backend: {backend}")

    # A little corpus: mail headers, one line per record (\r\n endings on
    # disk — the DFA needs them, hence keep_newline below).
    lines = [
        b"from:alice@gmail.com\r",
        b"date: Mon, 17 Aug 2026\r",
        b"from:bob@sub.domain-x.org\r",
        b"x-priority: 1\r",
        b"from:carol@x.yz\r",
    ] * 20
    tmp = tempfile.mkdtemp()
    corpus = os.path.join(tmp, "mail.txt")
    with open(corpus, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")

    found = []

    def on_batch(res, chars, lengths, n_valid):
        # device-side compact extraction: only matched runs come back
        out = extract_runs(
            res.all_substr_ids, res.masked_characters, max_runs=1, max_len=64
        )
        ok = np.asarray(res.match_ok)[:n_valid]
        lens = np.asarray(out["lengths"])[:n_valid, 0]
        payload = np.asarray(out["bytes"])[:n_valid, 0]
        for i in np.nonzero(ok)[0]:
            found.append(bytes(payload[i][: lens[i]]))

    job = ScanJob(
        matcher,
        [corpus],
        checkpoint_path=os.path.join(tmp, "job.json"),
        batch_size=32,
        on_batch=on_batch,
        keep_newline=True,
    )
    counters = job.run()
    print(counters.to_json())
    uniq = sorted(set(found))
    print(f"extracted {len(found)} addresses, {len(uniq)} unique: {uniq}")
    assert len(found) == 60, len(found)
    assert uniq == [b"alice@gmail.com", b"bob@sub.domain-x.org", b"carol@x.yz"]
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
