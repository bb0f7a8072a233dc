"""Large-DFA stress conformance (BASELINE configs[3] shape, scaled for CI):
a synthetic 1000-state dense DFA; the XLA backend must agree with the
oracle, and the Pallas kernel must refuse cleanly (bf16 exactness bound)."""

import numpy as np
import pytest

from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.models.defs import AllstrRegexDef, RegexDefs, SubstrRegexDef
from halo2_regex_tpu.ops import reference as ref_ops
from halo2_regex_tpu.ops.scan_jax import BatchMatcher, pack_batch


@pytest.fixture(scope="module")
def big_model():
    rng = np.random.default_rng(42)
    S = 1000
    allstr = AllstrRegexDef(
        first_state_val=0, accepted_state_val=7, largest_state_val=S - 1
    )
    line = 3
    for c in range(97, 123):  # a-z alphabet
        for s in range(S):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, S)))
            line += 1
    # one substr over a random transition subset
    trans = {(int(rng.integers(0, S)), int(rng.integers(0, S))) for _ in range(500)}
    sub = SubstrRegexDef(
        max_length=64,
        min_position=0,
        max_position=255,
        valid_state_transitions=trans,
        start_states=sorted({a for a, _ in list(trans)[:50]}),
        end_states=sorted({b for _, b in list(trans)[:50]}),
    )
    return CompiledRegexModel.from_defs(
        [RegexDefs(allstr=allstr, substrs=[sub])], max_chars_size=256
    )


def test_large_dfa_xla_vs_oracle(big_model):
    rng = np.random.default_rng(0)
    strings = [
        bytes(rng.integers(97, 123, size=int(rng.integers(0, 256))).astype(np.uint8))
        for _ in range(8)
    ]
    bm = BatchMatcher(big_model)
    chars, lengths = pack_batch(strings, 256)
    res = bm(chars, lengths)
    for i, s in enumerate(strings):
        oracle = ref_ops.match_substrs(big_model.regex_defs, s, 256)
        for name in ("states", "substr_ids_per_def", "mask", "all_substr_ids",
                     "accepted", "has_dead", "match_ok"):
            np.testing.assert_array_equal(
                np.asarray(getattr(res, name))[i].astype(np.int64),
                np.asarray(getattr(oracle, name)).astype(np.int64),
                err_msg=f"row {i} field {name}",
            )


def test_large_dfa_gpu_kernel_refuses_cleanly(big_model):
    """A model beyond the packed table's 2**16 states is refused by an
    explicit check (best_matcher's auto choice then takes XLA)."""
    import dataclasses

    from halo2_regex_tpu.ops import best_matcher
    from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher, table_fit

    assert table_fit(big_model) is None
    too_big = dataclasses.replace(big_model, s_pad=1 << 17)
    assert "states" in table_fit(too_big)
    with pytest.raises(ValueError, match="states"):
        GpuScanMatcher(too_big, interpret=True)
    with pytest.raises(ValueError, match="states"):
        best_matcher(too_big, backend="gpu", interpret=True)


def test_large_dfa_dead_on_foreign_byte(big_model):
    res = BatchMatcher(big_model).match_one(b"abc!")  # '!' has no transition
    assert bool(res.has_dead[0])
    assert not bool(res.match_ok)


def test_large_dfa_gpu_kernel_wide_states(big_model):
    """>256-state models run on the fused kernel (states past a byte in
    the packed word), bit-exact vs the oracle (Pallas interpreter)."""
    from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher

    m = GpuScanMatcher(big_model, interpret=True)
    assert big_model.s_pad > 256
    rng = np.random.default_rng(3)
    strings = [
        bytes(rng.integers(97, 123, size=int(rng.integers(0, 64))).astype(np.uint8))
        for _ in range(6)
    ] + [b""]
    chars, lengths = pack_batch(strings, big_model.max_chars_size)
    res = m(chars, lengths)
    for i, s in enumerate(strings):
        oracle = ref_ops.match_substrs(big_model.regex_defs, s,
                                       big_model.max_chars_size)
        for name in res.field_names():
            np.testing.assert_array_equal(
                np.asarray(getattr(res, name))[i].astype(np.int64),
                np.asarray(getattr(oracle, name)).astype(np.int64),
                err_msg=f"row {i} field {name}",
            )
