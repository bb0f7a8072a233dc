"""Property fuzz: compiled-DFA acceptance == Python `re` on the toy grammar.

Generates random patterns from the reference grammar (literals,
alternation, grouping, * + ?, the five control escapes — regex.js:236-367
semantics: no char classes, no anchors, `.` is a literal dot) plus random
matching/non-matching inputs, and checks that walking our compiled DFA
agrees with `re.fullmatch` on an escaped translation of the same pattern.
The reference has no equivalent test; its compiler is only exercised by
three fixtures.
"""

import re

import numpy as np
import pytest

from halo2_regex_tpu.compiler.dfa import dfa_to_json, regex_to_dfa

ALPHA = list("abc d.:@-")  # small alphabet incl. space, dot, punctuation


def gen_pattern(rng, depth=0):
    """Random pattern in the toy grammar; returns (our_syntax, py_syntax)."""
    r = rng.random()
    if depth >= 3 or r < 0.35:
        ch = ALPHA[rng.integers(0, len(ALPHA))]
        return ch, re.escape(ch)
    if r < 0.55:
        a, pa = gen_pattern(rng, depth + 1)
        b, pb = gen_pattern(rng, depth + 1)
        return a + b, pa + pb
    if r < 0.7:
        a, pa = gen_pattern(rng, depth + 1)
        b, pb = gen_pattern(rng, depth + 1)
        return f"({a}|{b})", f"(?:{pa}|{pb})"
    a, pa = gen_pattern(rng, depth + 1)
    op = "*+?"[rng.integers(0, 3)]
    return f"({a}){op}", f"(?:{pa}){op}"


def compile_dfa(pattern):
    import json as _json

    nodes = dfa_to_json(regex_to_dfa(pattern))
    trans = {}
    accept = set()
    for i, node in enumerate(nodes):
        if node["type"] == "accept":
            accept.add(i)
        for key, nxt in node["edges"].items():
            for ch in _json.loads(key):
                trans[(i, ch)] = nxt
    return trans, accept


def walk(trans, accept, s):
    st = 0
    for ch in s:
        nxt = trans.get((st, ch))
        if nxt is None:
            return False
        st = nxt
    return st in accept


def gen_input(rng, n):
    return "".join(ALPHA[rng.integers(0, len(ALPHA))] for _ in range(n))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dfa_agrees_with_re(seed):
    rng = np.random.default_rng(seed)
    checked = 0
    for _ in range(60):
        pat, py_pat = gen_pattern(rng)
        try:
            trans, accept = compile_dfa(pat)
        except RecursionError:
            continue
        py = re.compile(py_pat)
        inputs = {gen_input(rng, int(rng.integers(0, 8))) for _ in range(12)}
        # bias toward strings the pattern actually matches
        for _ in range(6):
            m = py.fullmatch(gen_input(rng, int(rng.integers(0, 10))))
            if m:
                inputs.add(m.group(0))
        for s in inputs:
            ours = walk(trans, accept, s)
            theirs = py.fullmatch(s) is not None
            assert ours == theirs, (pat, s, ours, theirs)
            checked += 1
    assert checked > 300  # the generator actually produced cases


def test_gpu_kernel_matches_re_on_random_models():
    """End-to-end: random toy-grammar model -> packed table -> fused GPU
    kernel (Pallas interpreter) must agree with `re` acceptance."""
    from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
    from halo2_regex_tpu.models.compiled import CompiledRegexModel
    from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher
    from halo2_regex_tpu.ops.scan_jax import pack_batch

    rng = np.random.default_rng(42)
    models_checked = 0
    for _ in range(40):
        if models_checked >= 8:
            break
        pat, py_pat = gen_pattern(rng)
        py = re.compile(py_pat)
        # need a pattern that can match something non-empty
        samples = [
            m.group(0)
            for m in (
                py.fullmatch(gen_input(rng, int(rng.integers(1, 10))))
                for _ in range(40)
            )
            if m and m.group(0)
        ]
        if not samples:
            continue
        cfg = DecomposedRegexConfig.from_json(
            {
                "max_byte_size": 16,
                "parts": [
                    {"is_public": False, "regex_def": pat, "max_size": 16}
                ],
            }
        )
        try:
            # multi_accept honors every accepting DFA state (patterns with
            # optional tails like (x)? are routine in the generator)
            model = CompiledRegexModel.from_decomposed(
                cfg, max_chars_size=16, multi_accept=True
            )
        except Exception:
            continue  # compiler edge: covered by the compiler fuzz above
        matcher = GpuScanMatcher(model, interpret=True)
        inputs = set(samples[:4])
        inputs.update(gen_input(rng, int(rng.integers(0, 10))) for _ in range(6))
        inputs = sorted(s for s in inputs if len(s) <= 16)
        chars, lengths = pack_batch([s.encode() for s in inputs], 16)
        ours = np.asarray(matcher(chars, lengths).match_ok).tolist()
        theirs = [py.fullmatch(s) is not None for s in inputs]
        assert ours == theirs, (pat, inputs, ours, theirs)
        models_checked += 1
    assert models_checked >= 8
