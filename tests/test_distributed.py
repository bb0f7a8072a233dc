"""Multi-device paths on the virtual 8-device CPU mesh.

Data-parallel corpus sharding (replicated tables, psum-reduced stats) and
the sequence-sharded blockwise scan must both reproduce the single-device
results exactly (SURVEY §7 "multi-host determinism": identical per-shard
outputs independent of shard layout).
"""

import jax
import numpy as np
import pytest

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.ops import reference as ref_ops
from halo2_regex_tpu.ops.scan_jax import BatchMatcher, pack_batch
from halo2_regex_tpu.parallel.data_parallel import DistributedMatcher
from halo2_regex_tpu.parallel.mesh import make_mesh
from halo2_regex_tpu.parallel.seq_parallel import SeqShardedMatcher

from fixtures import CONFIGS

MAX_LEN = 64


@pytest.fixture(scope="module")
def model3():
    return CompiledRegexModel.from_decomposed(
        DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=MAX_LEN
    )


STRINGS = [
    b"from:alice@gmail.com\r\n",
    b"dummy\r\nfrom:alice<alice@gmail.com>\r\n",
    b"from:alice<alicegmail.com>\r\n",
    b"from:bob@x.yz\r\n",
    b"",
    b"from:alice<alice@gmail.com>",
    b"from:carol.d@sub.domain-x.org\r\n",
    b"fromalice<alice@gmail.com>\r\n",
]


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_data_parallel_matches_oracle(model3):
    mesh = make_mesh()  # 8 x 1
    dm = DistributedMatcher(model3, mesh)
    chars, lengths = pack_batch(STRINGS, MAX_LEN)
    result, stats = dm(chars, lengths)
    expected_ok = []
    for i, s in enumerate(STRINGS):
        oracle = ref_ops.match_substrs(model3.regex_defs, s, MAX_LEN)
        expected_ok.append(bool(oracle.match_ok))
        np.testing.assert_array_equal(
            np.asarray(result.masked_characters)[i], oracle.masked_characters
        )
        np.testing.assert_array_equal(
            np.asarray(result.all_substr_ids)[i], oracle.all_substr_ids
        )
    np.testing.assert_array_equal(np.asarray(result.match_ok), expected_ok)
    assert int(stats["n_matched"]) == sum(expected_ok)
    assert int(stats["bytes_scanned"]) == sum(len(s) for s in STRINGS)


def test_data_parallel_output_sharded(model3):
    mesh = make_mesh()
    dm = DistributedMatcher(model3, mesh)
    chars, lengths = pack_batch(STRINGS, MAX_LEN)
    result, _ = dm(chars, lengths)
    shard = result.mask.sharding
    # batch axis stays sharded over the data axis — no gather of per-byte
    # outputs (SURVEY §7: psum only on reductions)
    assert shard.spec[0] == "data"


@pytest.mark.parametrize("seq", [2, 4])
def test_seq_sharded_matches_batch(model3, seq):
    mesh = make_mesh(seq=seq)  # (8/seq) x seq
    sm = SeqShardedMatcher(model3, mesh)
    bm = BatchMatcher(model3)
    chars, lengths = pack_batch(STRINGS, MAX_LEN)
    out = sm(chars, lengths)
    ref = bm(chars, lengths)
    np.testing.assert_array_equal(np.asarray(out["match_ok"]), np.asarray(ref.match_ok))
    np.testing.assert_array_equal(
        np.asarray(out["masked_characters"]), np.asarray(ref.masked_characters)
    )
    np.testing.assert_array_equal(
        np.asarray(out["all_substr_ids"]), np.asarray(ref.all_substr_ids)
    )
    np.testing.assert_array_equal(
        np.asarray(out["substr_id_sum"]), np.asarray(ref.substr_id_sum)
    )
    np.testing.assert_array_equal(np.asarray(out["fwd_mask"]), np.asarray(ref.fwd_mask))
    np.testing.assert_array_equal(np.asarray(out["bwd_mask"]), np.asarray(ref.bwd_mask))
    # states agree on the real prefix of every row
    st = np.asarray(out["states_after"])  # [B, n_defs, L]
    for i, s in enumerate(STRINGS):
        oracle_states, _ = ref_ops.derive_states(model3.regex_defs, s)
        np.testing.assert_array_equal(st[i, 0, : len(s)], oracle_states[0][1:])


def test_seq_sharded_long_input(model3):
    """64KB-style long-input path, sequence-sharded (BASELINE configs[3]
    shape, scaled down for CPU)."""
    mesh = make_mesh(seq=4)
    L = 4096
    model = CompiledRegexModel.from_decomposed(
        DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=L
    )
    sm = SeqShardedMatcher(model, mesh)
    filler = b"x" * 3000
    s = filler + b"\r\nfrom:alice@gmail.com\r\n"
    chars, lengths = pack_batch([s, s[:100]], L)
    out = sm(chars, lengths)
    oracle = ref_ops.match_substrs(model.regex_defs, s, L)
    np.testing.assert_array_equal(
        np.asarray(out["masked_characters"])[0], oracle.masked_characters
    )
    assert bool(np.asarray(out["match_ok"])[0]) == bool(oracle.match_ok)


def test_seq_sharded_match_full_result(model3):
    """SeqShardedMatcher.match returns a full RegexResult bit-identical to
    the BatchMatcher."""
    mesh = make_mesh(seq=2)
    sm = SeqShardedMatcher(model3, mesh)
    bm = BatchMatcher(model3)
    strings = STRINGS + [b"y" * MAX_LEN]  # include a full-length input
    # pad to multiple of data axis
    while len(strings) % mesh.shape["data"] != 0:
        strings.append(b"")
    chars, lengths = pack_batch(strings, MAX_LEN)
    res = sm.match(chars, lengths)
    ref = bm(chars, lengths)
    for name in res.field_names():
        np.testing.assert_array_equal(
            np.asarray(getattr(res, name)).astype(np.int64),
            np.asarray(getattr(ref, name)).astype(np.int64),
            err_msg=f"field {name}",
        )


def test_data_parallel_gpu_kernel_per_shard(model3):
    """DistributedMatcher with the fused GPU kernel per shard (Pallas
    interpreter on the CPU mesh): bit-exact vs the XLA distributed result
    on every field, and the stats agree with the oracle."""
    mesh = make_mesh()  # 8 x 1
    dm = DistributedMatcher(model3, mesh, backend="gpu", interpret=True)
    strings = STRINGS * 8  # 64 rows -> 8 per shard
    chars, lengths = pack_batch(strings, MAX_LEN)
    result, stats = dm(chars, lengths)
    expected, _ = DistributedMatcher(model3, mesh)(chars, lengths)
    for name in expected.field_names():
        np.testing.assert_array_equal(
            np.asarray(getattr(result, name)),
            np.asarray(getattr(expected, name)),
            err_msg=f"field {name}",
        )
    n_ok = sum(
        bool(ref_ops.match_substrs(model3.regex_defs, s, MAX_LEN).match_ok)
        for s in strings
    )
    assert int(stats["n_matched"]) == n_ok
