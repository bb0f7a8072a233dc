"""Speculative sequence sharding (docs/ROADMAP.md #7): per-shard scans from
speculated entry states + boundary fixed-point iteration, bit-exact vs the
exact map-composition scheme, with pluggable per-shard kernels (XLA scan /
segmented split-Pallas)."""

import numpy as np
import pytest

import jax

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.models.defs import AllstrRegexDef, RegexDefs
from halo2_regex_tpu.ops.scan_jax import pack_batch
from halo2_regex_tpu.parallel.mesh import make_mesh
from halo2_regex_tpu.parallel.seq_parallel import (
    SeqShardedMatcher,
    SpeculativeSeqMatcher,
)

from fixtures import CONFIGS

L = 128
STRINGS = [
    b"from:alice@gmail.com\r\n",
    b"",
    b"dummy\r\nfrom:alice<alice@gmail.com>\r\n",
    b"from:alice<alicegmail.com>\r\n",
    b"x" * (L - 1),
    b"from:a@b.cd\r\n" + b"y" * 90,
    b"\r\n" * 40,
    b"from:x.y@z.ww\r\n",
]


@pytest.fixture(scope="module")
def model3():
    return CompiledRegexModel.from_decomposed(
        DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=L
    )


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, seq=4, devices=jax.devices()[:8])


def _assert_equal(a, b):
    for k in a:
        np.testing.assert_array_equal(
            np.asarray(a[k]), np.asarray(b[k]), err_msg=k
        )


def test_speculative_xla_matches_exact(model3, mesh):
    chars, lengths = pack_batch(STRINGS, L)
    exact = SeqShardedMatcher(model3, mesh)(chars, lengths)
    spec = SpeculativeSeqMatcher(model3, mesh, per_shard="xla")(chars, lengths)
    _assert_equal(exact, {k: spec[k] for k in exact})
    # resync-friendly model: the fixed point lands in <= 2 rounds
    assert int(np.asarray(spec["spec_rounds"])[0]) <= 2


def test_speculative_gpu_kernel_matches_exact(model3, mesh):
    chars, lengths = pack_batch(STRINGS, L)
    exact = SeqShardedMatcher(model3, mesh)(chars, lengths)
    spec = SpeculativeSeqMatcher(
        model3, mesh, per_shard="gpu", interpret=True
    )(chars, lengths)
    _assert_equal(exact, {k: spec[k] for k in exact})


def test_speculative_adversarial_random_table():
    """A random dense table never resynchronizes: the fixed point needs the
    full n_seq rounds and must still be exact."""
    rng = np.random.default_rng(3)
    S, Lr = 64, 64
    allstr = AllstrRegexDef(
        first_state_val=0, accepted_state_val=1, largest_state_val=S - 1
    )
    line = 3
    for c in range(97, 107):
        for s in range(S):
            allstr.state_lookup[(c, s)] = (line, int(rng.integers(0, S)))
            line += 1
    model = CompiledRegexModel.from_defs(
        [RegexDefs(allstr=allstr, substrs=[])], max_chars_size=Lr
    )
    mesh = make_mesh(data=1, seq=8, devices=jax.devices()[:8])
    chars = rng.integers(97, 107, size=(4, Lr)).astype(np.uint8)
    lengths = np.array([Lr, Lr - 7, 3, 0], np.int32)
    exact = SeqShardedMatcher(model, mesh)(chars, lengths)
    spec = SpeculativeSeqMatcher(model, mesh, per_shard="xla")(chars, lengths)
    _assert_equal(exact, {k: spec[k] for k in exact})
    assert int(np.asarray(spec["spec_rounds"])[0]) >= 2


def test_seq_axis_size_one(model3):
    mesh1 = make_mesh(data=4, seq=1, devices=jax.devices()[:4])
    chars, lengths = pack_batch(STRINGS, L)
    exact = SeqShardedMatcher(model3, mesh1)(chars, lengths)
    spec = SpeculativeSeqMatcher(model3, mesh1, per_shard="xla")(chars, lengths)
    _assert_equal(exact, {k: spec[k] for k in exact})
    assert int(np.asarray(spec["spec_rounds"])[0]) == 1


def test_speculative_match_api(model3, mesh):
    """SpeculativeSeqMatcher.match returns the same full RegexResult view
    as SeqShardedMatcher.match (shared assembly)."""
    chars, lengths = pack_batch(STRINGS, L)
    a = SeqShardedMatcher(model3, mesh).match(chars, lengths)
    b = SpeculativeSeqMatcher(model3, mesh).match(chars, lengths)
    for f in a.field_names():
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )
