"""Multi-accept DFA support (opt-in table-format extension).

The reference text format holds exactly ONE accepted state
(/root/reference/src/defs.rs:31-33): a decomposed regex whose final part
has an optional tail like ``(!)?`` minimizes to a DFA with several
accepting states, and the reference silently keeps only the first —
inputs reaching the others are rejected.  The opt-in extension records
the full accepting-state set (model ``multi_accept=True``, allstr line 1
as a space-separated list) while the default stays byte-identical to the
reference.
"""

import io
import re
import warnings

import numpy as np
import pytest

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.models.defs import AllstrRegexDef
from halo2_regex_tpu.ops import reference as ref_ops
from halo2_regex_tpu.ops.scan_jax import BatchMatcher, pack_batch
from halo2_regex_tpu.witness.checker import check_witness

MAX_LEN = 64

CONFIG = {
    "max_byte_size": MAX_LEN,
    "parts": [
        {"is_public": False, "regex_def": "id: ", "max_size": 4},
        {"is_public": True, "regex_def": "(a|b)+", "max_size": 16},
        {"is_public": False, "regex_def": "(!)?", "max_size": 1},
    ],
}
# Python-re view of the same grammar (the toy grammar's (a|b)+ and (!)?
# mean the same thing here).
PY_RE = re.compile(rb"id: (a|b)+(!)?")

POSITIVE_TAIL = b"id: abba!"
POSITIVE_NOTAIL = b"id: abba"
NEGATIVES = [b"id: ", b"id: abba!!", b"xid: a", b"id: abc"]


@pytest.fixture(scope="module")
def cfg():
    return DecomposedRegexConfig.from_json(CONFIG)


def test_config_is_multi_accept(cfg):
    nodes = cfg.compile_dfa()
    accepts = [i for i, n in enumerate(nodes) if n.type == "accept"]
    assert len(accepts) > 1, "fixture must exercise the multi-accept case"


def test_default_semantics_warn_and_reject_tail(cfg):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        model = CompiledRegexModel.from_decomposed(cfg, max_chars_size=MAX_LEN)
    assert any("accepting states" in str(x.message) for x in w)
    # the reference footgun: exactly one of the two valid inputs passes
    oks = []
    for s in (POSITIVE_NOTAIL, POSITIVE_TAIL):
        res = ref_ops.match_substrs(model.regex_defs, s, MAX_LEN)
        oks.append(bool(res.match_ok))
    assert sorted(oks) == [False, True]


@pytest.fixture(scope="module")
def model_ma(cfg):
    return CompiledRegexModel.from_decomposed(
        cfg, max_chars_size=MAX_LEN, multi_accept=True
    )


def test_multi_accept_oracle_and_checker(model_ma):
    for s in (POSITIVE_NOTAIL, POSITIVE_TAIL):
        res = ref_ops.match_substrs(model_ma.regex_defs, s, MAX_LEN)
        assert bool(res.match_ok), s
        assert check_witness(model_ma.regex_defs, res) == []
        # the public part is still extracted
        ids = np.asarray(res.all_substr_ids)
        got = bytes(
            int(c)
            for c, i in zip(np.asarray(res.all_characters), ids)
            if i != 0
        )
        assert got == b"abba"
    for s in NEGATIVES:
        res = ref_ops.match_substrs(model_ma.regex_defs, s, MAX_LEN)
        assert not bool(res.match_ok), s


def test_backends_match_python_re(model_ma):
    strings = [
        POSITIVE_NOTAIL,
        POSITIVE_TAIL,
        *NEGATIVES,
        b"id: a",
        b"id: b!",
        b"id: " + b"ab" * 8,
    ]
    expect = [PY_RE.fullmatch(s) is not None for s in strings]
    chars, lengths = pack_batch(strings, MAX_LEN)

    got_xla = np.asarray(BatchMatcher(model_ma)(chars, lengths).match_ok)
    assert got_xla.tolist() == expect

    from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher

    for columns in ("full", "witness", "match"):
        out = GpuScanMatcher(model_ma, columns=columns, interpret=True)(
            chars, lengths
        )
        got = out.match_ok if columns == "full" else out["match_ok"]
        assert np.asarray(got).tolist() == expect, columns


def test_text_format_extension_round_trip(cfg, tmp_path):
    allstr = tmp_path / "allstr.txt"
    subs = [tmp_path / "substr0.txt"]
    cfg.gen_regex_files(str(allstr), [str(p) for p in subs], multi_accept=True)
    text = allstr.read_text()
    line1 = text.splitlines()[1]
    accepts = [int(x) for x in line1.split()]
    assert len(accepts) > 1

    # reader picks up the extension; accept_set flows through the model
    d = AllstrRegexDef.read_from_text(str(allstr))
    assert d.accept_states_ext == accepts
    assert d.accepted_state_val == accepts[0]
    model = CompiledRegexModel.from_texts(
        [(text, [p.read_text() for p in subs])], MAX_LEN
    )
    assert model.accept_mask[0, accepts].all()
    assert model.regex_defs[0].accept_set == accepts

    # serializer round-trips the extension
    assert d.to_text() == text

    # both valid inputs pass through the text-loaded model
    for s in (POSITIVE_NOTAIL, POSITIVE_TAIL):
        res = ref_ops.match_substrs(model.regex_defs, s, MAX_LEN)
        assert bool(res.match_ok), s


def test_default_files_stay_reference_identical(cfg, tmp_path):
    """multi_accept=False writes the plain single-accept format."""
    allstr = tmp_path / "allstr.txt"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg.gen_regex_files(str(allstr), [str(tmp_path / "s0.txt")])
    line1 = allstr.read_text().splitlines()[1]
    assert len(line1.split()) == 1
    d = AllstrRegexDef.read_from_text(str(allstr))
    assert d.accept_states_ext is None
    assert d.to_text() == allstr.read_text()
