"""End-to-end multi-host launcher test: TWO real processes, CPU backend.

Spawns two `python -m halo2_regex_tpu.parallel.launch` processes joined
through a localhost jax.distributed coordinator, each with 2 virtual CPU
devices (4 global devices on the data axis).  Exercises the whole
multi-host path the cluster launcher uses — jax.distributed.initialize,
global mesh construction, per-process corpus sharding,
make_array_from_process_local_data, and the psum-reduced statistics —
which virtual single-process mesh tests cannot reach.

Reference behavior being validated: the corpus scan statistics equal a
single-process oracle count over the same files.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from halo2_regex_tpu.models import zoo  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_launch(tmp_path):
    model = zoo.email_headers_model(max_chars_size=64, headers=("from",))
    model_path = tmp_path / "model.npz"
    model.save(model_path)

    # two UNEVEN corpus shards, one per process (round-robin on sorted
    # paths; different batch counts exercise the step-count sync)
    lines0 = [b"from:alice@gmail.com\r", b"junk", b"from:bob@x.yz\r"] * 4
    lines1 = [b"from:carol@sub.domain-x.org\r", b"nope"] * 4
    (tmp_path / "shard-0.txt").write_bytes(b"\n".join(lines0) + b"\n")
    (tmp_path / "shard-1.txt").write_bytes(b"\n".join(lines1) + b"\n")
    expect_matched = 8 + 4  # from: lines (accept state needs the \r\n)
    expect_strings = len(lines0) + len(lines1)

    port = _free_port()
    # each process gets two virtual CPU devices and only this checkout
    # on its path
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "PYTHONPATH": REPO,
    }
    procs = []
    for pid in range(2):
        cmd = [
            sys.executable,
            "-m",
            "halo2_regex_tpu.parallel.launch",
            "--model",
            str(model_path),
            "--corpus",
            str(tmp_path / "shard-*.txt"),
            "--batch-per-host",
            "8",
            "--coordinator",
            f"127.0.0.1:{port}",
            "--num-processes",
            "2",
            "--process-id",
            str(pid),
            "--keep-newline",
        ]
        procs.append(
            subprocess.Popen(
                cmd,
                env=env_base,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                cwd=str(tmp_path),
            )
        )
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"launch process failed rc={rc}\n{err.decode()[-2000:]}"

    # process 0 prints the psum-reduced totals
    stats_line = [
        ln
        for ln in outs[0][1].decode().splitlines()
        if ln.startswith("{") and "n_matched" in ln
    ]
    assert stats_line, f"no stats line in stdout: {outs[0][1].decode()!r}"
    stats = json.loads(stats_line[-1])
    assert stats["n_matched"] == expect_matched, stats
    assert stats["strings"] == expect_strings, stats
    assert stats["n_dead"] >= 0
    assert stats["bytes_scanned"] > 0
