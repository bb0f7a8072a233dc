"""The fused GPU scan kernel (ops/gpu_scan.py) through the Pallas
interpreter: every fixture and zoo model x every ``columns`` mode, bit-exact
vs the oracle (ops/reference.py), plus the packed-table builder, the
compact-witness round trip and the entry-state scan.

Tests of the kernel compiled for the card carry the ``gpu`` marker and
skip here (see the ``gpu_device`` fixture)."""

import functools

import jax
import numpy as np
import pytest

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models import zoo
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.ops import reference as ref_ops
from halo2_regex_tpu.ops.gpu_scan import (
    GpuScanMatcher,
    build_packed_table,
    table_fit,
)
from halo2_regex_tpu.ops.scan_jax import BatchMatcher, pack_batch
from halo2_regex_tpu.witness.expand import expand_witness

from fixtures import CONFIGS

L = 64

HEADERS = [
    b"from:alice@gmail.com\r\n",
    b"dummy\r\nfrom:Alice X <alice@gmail.com>\r\n",
    b"x\r\nto:bob@x.yz\r\n",
    b"x\r\nsubject:hello world\r\n",
    b'xx Content-Type: text/plain; charset="UTF-8"\r\n\r\n',
]
REGEX12 = [
    b"email was meant for @y. Also for x.",
    b"email was meant for @yajk. Also for swq.",
    b"email was meant for @@",
]
COMMON = [b"", bytes([0, 1, 2]), b"x" * L, b"from:alice<alicegmail.com>\r\n"]


def _fixture(*names, multi_accept=False):
    cfgs = [DecomposedRegexConfig.from_json(CONFIGS[n]) for n in names]
    return CompiledRegexModel.from_decomposed(
        cfgs, max_chars_size=L, multi_accept=multi_accept
    )


def _random_table(n_states, seed=0):
    return zoo.random_table_model(
        n_states, L, seed=seed, alphabet=range(97, 103)
    )


MODELS = {
    "regex1": lambda: _fixture("regex1"),
    "regex2": lambda: _fixture("regex2"),
    "regex3": lambda: _fixture("regex3"),
    "regex1+2": lambda: _fixture("regex1", "regex2"),
    "regex1+2+3": lambda: _fixture("regex1", "regex2", "regex3"),
    "regex3_multi_accept": lambda: _fixture("regex3", multi_accept=True),
    "email_from": lambda: zoo.email_headers_model(L, headers=("from",)),
    "email_to": lambda: zoo.email_headers_model(L, headers=("to",)),
    "email_subject": lambda: zoo.email_headers_model(L, headers=("subject",)),
    "email_headers_3": lambda: zoo.email_headers_model(L),
    "body_prefix": lambda: CompiledRegexModel.from_decomposed(
        zoo.get_config("body_prefix", L), max_chars_size=L
    ),
    "random_300_states": lambda: _random_table(300),
}


@functools.lru_cache(maxsize=None)
def model_of(name):
    return MODELS[name]()


def strings_for(name):
    if name.startswith("random"):
        rng = np.random.default_rng(5)
        return [
            rng.integers(97, 103, size=n).astype(np.uint8).tobytes()
            for n in (0, 1, 17, L - 1, L)
        ] + [b"abz"]  # 'z' has no transition: DEAD
    return (REGEX12 if "regex1" in name else HEADERS) + COMMON


def assert_rows_match_oracle(model, strings, get_row):
    for i, s in enumerate(strings):
        oracle = ref_ops.match_substrs(model.regex_defs, s, model.max_chars_size)
        row = get_row(i)
        for name in oracle.field_names():
            np.testing.assert_array_equal(
                np.asarray(getattr(row, name)).astype(np.int64),
                np.asarray(getattr(oracle, name)).astype(np.int64),
                err_msg=f"row {i} field {name}",
            )


@pytest.mark.parametrize("columns", ["full", "witness", "match"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_vs_oracle(name, columns):
    model = model_of(name)
    strings = strings_for(name)
    chars, lengths = pack_batch(strings, L)
    out = GpuScanMatcher(model, columns=columns, interpret=True)(chars, lengths)
    if columns == "full":
        res = out.map(np.asarray)
        assert_rows_match_oracle(model, strings, lambda i: res.map(lambda a: a[i]))
    elif columns == "witness":
        res = expand_witness(model, {k: np.asarray(v) for k, v in out.items()}, chars)
        assert_rows_match_oracle(model, strings, lambda i: res.map(lambda a: a[i]))
    else:
        for i, s in enumerate(strings):
            oracle = ref_ops.match_substrs(model.regex_defs, s, L)
            final = np.asarray(out["final_states"])[i]
            assert final.tolist() == [st[len(s)] for st in _raw_states(model, s)]
            for k in ("accepted", "has_dead", "match_ok"):
                np.testing.assert_array_equal(
                    np.asarray(out[k])[i], getattr(oracle, k), err_msg=k
                )


def _raw_states(model, s):
    states, _ = ref_ops.derive_states(model.regex_defs, s)
    return states


@pytest.mark.parametrize(
    "name", ["regex1+2+3", "email_headers_3", "regex3_multi_accept", "random_300_states"]
)
def test_packed_table_matches_model_tables(name):
    model = model_of(name)
    packed = build_packed_table(model).view(np.uint32).astype(np.int64)
    assert packed.shape == (model.n_defs, 256, model.s_pad)
    S = model.s_pad
    cur = np.broadcast_to(np.arange(S)[None, :], (256, S))
    for d in range(model.n_defs):
        w = packed[d]
        nxt = w & 0xFFFF
        ids = (w >> 16) & 0x3FFF
        np.testing.assert_array_equal(nxt, model.transition[d])
        np.testing.assert_array_equal(ids, model.substr_id_table[d][cur, nxt])
        np.testing.assert_array_equal(
            (w >> 30) & 1, model.is_start_table[ids, cur].astype(np.int64)
        )
        np.testing.assert_array_equal(
            (w >> 31) & 1, model.is_end_table[ids, nxt].astype(np.int64)
        )


def test_table_fit_refuses_too_many_substrs():
    import dataclasses

    model = model_of("regex3")
    big = np.zeros(((1 << 14) + 1, model.s_pad), bool)
    crowded = dataclasses.replace(model, is_start_table=big, is_end_table=big)
    assert "substrs" in table_fit(crowded)
    with pytest.raises(ValueError, match="substrs"):
        build_packed_table(crowded)


@pytest.mark.parametrize("name", ["regex1+2", "email_from", "random_300_states"])
def test_witness_round_trip_equals_full(name):
    """expand_witness(compact columns) reproduces the full column set."""
    model = model_of(name)
    chars, lengths = pack_batch(strings_for(name), L)
    w = GpuScanMatcher(model, columns="witness", interpret=True)(chars, lengths)
    full = GpuScanMatcher(model, interpret=True)(chars, lengths)
    exp = expand_witness(model, {k: np.asarray(v) for k, v in w.items()}, chars)
    for k in full.field_names():
        np.testing.assert_array_equal(
            np.asarray(getattr(exp, k)).astype(np.int64),
            np.asarray(getattr(full, k)).astype(np.int64),
            err_msg=k,
        )
    flags = np.asarray(w["flags"])
    np.testing.assert_array_equal((flags >> 3) & 1, np.asarray(full.all_enable_flags))
    np.testing.assert_array_equal(
        (flags >> 4) & 1, (np.asarray(full.is_start_sum)[:, :L] > 0).astype(np.uint8)
    )
    np.testing.assert_array_equal(
        (flags >> 5) & 1, (np.asarray(full.is_end_sum)[:, 1:] > 0).astype(np.uint8)
    )


@pytest.mark.parametrize(
    "name,state_dtype", [("regex3", np.uint8), ("random_300_states", np.uint16)]
)
def test_witness_dtypes_are_narrowest(name, state_dtype):
    m = GpuScanMatcher(model_of(name), columns="witness", interpret=True)
    chars, lengths = pack_batch(strings_for(name)[:2], L)
    w = m(chars, lengths)
    assert w["states"].dtype == state_dtype
    assert w["masked_characters"].dtype == np.uint8
    assert w["flags"].dtype == np.uint8


@pytest.mark.parametrize("name", ["regex1+2", "random_300_states"])
def test_entry_state_scan(name):
    """scan_from: raw per-position states from per-string entry states,
    vs a numpy walk of the transition table."""
    model = model_of(name)
    strings = strings_for(name)
    chars, _ = pack_batch(strings, L)
    rng = np.random.default_rng(9)
    B = len(strings)
    entries = np.stack([
        rng.integers(0, model.dead_states[d] + 1, size=B)
        for d in range(model.n_defs)
    ]).astype(np.int32)
    after = np.asarray(GpuScanMatcher(model, interpret=True).scan_from(chars, entries))
    assert after.shape == (model.n_defs, B, L)
    for d in range(model.n_defs):
        cur = entries[d].copy()
        for t in range(L):
            cur = model.transition[d][chars[:, t], cur]
            np.testing.assert_array_equal(after[d, :, t], cur, err_msg=f"t={t}")


def test_columns_validated():
    with pytest.raises(ValueError, match="columns"):
        GpuScanMatcher(model_of("regex3"), columns="planes", interpret=True)


def test_compiled_kernel_needs_a_gpu():
    with pytest.raises(ValueError, match="GPU"):
        GpuScanMatcher(model_of("regex3"))


# ---------------------------------------------------------- on the card
@pytest.fixture
def gpu_device():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU lowering")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("columns", ["full", "witness", "match"])
def test_compiled_kernel_matches_xla(gpu_device, columns):
    from halo2_regex_tpu.utils.corpus import email_corpus

    model = zoo.email_headers_model(1024, headers=("from",))
    chars, lengths = email_corpus(4096, 1024, seed=0)
    out = GpuScanMatcher(model, columns=columns)(chars, lengths)
    ref = BatchMatcher(model)(chars, lengths)
    got = out.match_ok if columns == "full" else out["match_ok"]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref.match_ok))
    if columns == "full":
        for k in ref.field_names():
            np.testing.assert_array_equal(
                np.asarray(getattr(out, k)), np.asarray(getattr(ref, k)), err_msg=k
            )
