"""halo2_regex_tpu — a batched DFA regex-matching and witness-generation
framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
zkemail/halo2-regex: decomposed regexes compile to dense byte-level DFA
transition tables; the per-byte state scan, substring-id tagging, masked
extraction and witness-row emission run as one fused GPU kernel (or the
portable XLA scan), scaling data-parallel across a device mesh.

Quick start::

    import halo2_regex_tpu as h2r

    cfg = h2r.DecomposedRegexConfig.from_json({
        "max_byte_size": 64,
        "parts": [
            {"is_public": False, "regex_def": "email was meant for @", "max_size": 21},
            {"is_public": True, "regex_def": "(a|b|c)+", "max_size": 7},
            {"is_public": False, "regex_def": ".", "max_size": 1},
        ],
    })
    model = h2r.CompiledRegexModel.from_decomposed(cfg)
    matcher = h2r.BatchMatcher(model)
    result = matcher.match_one(b"email was meant for @abc.")
    h2r.extract_substrings(result)   # [(21, 'abc', 1)]
"""

import sys as _sys

# The compiler front-end recurses over deep alternation ASTs (98-way
# catch-all groups under +/? are standard in zk-email regexes).
if _sys.getrecursionlimit() < 20_000:
    _sys.setrecursionlimit(20_000)

from .compiler.decomposed import DecomposedRegexConfig, RegexPartConfig, VrmError
from .compiler.dfa import regex_to_dfa
from .compiler.parser import RegexParseError, parse_regex
from .compiler.pipeline import compile_allstr_text, dfa_to_regex_def_text
from .models.compiled import CompiledRegexModel
from .models.defs import AllstrRegexDef, RegexDefs, SubstrRegexDef
from .ops.reference import extract_substrings, match_substrs
from .ops.scan_jax import BatchMatcher, pack_batch
from .witness.checker import check_witness, verify
from .witness.result import RegexResult
from .witness.tables import build_all_tables

__version__ = "0.1.0"

# Heavier / optional-dependency entry points load lazily.
_LAZY = {
    "GpuScanMatcher": ("halo2_regex_tpu.ops.gpu_scan", "GpuScanMatcher"),
    "best_matcher": ("halo2_regex_tpu.ops", "best_matcher"),
    "DistributedMatcher": ("halo2_regex_tpu.parallel.data_parallel", "DistributedMatcher"),
    "SeqShardedMatcher": ("halo2_regex_tpu.parallel.seq_parallel", "SeqShardedMatcher"),
    "make_mesh": ("halo2_regex_tpu.parallel.mesh", "make_mesh"),
    "CorpusLoader": ("halo2_regex_tpu.utils.io", "CorpusLoader"),
    "Counters": ("halo2_regex_tpu.utils.trace", "Counters"),
    "check_witness_batch": ("halo2_regex_tpu.witness.checker", "check_witness_batch"),
    "expand_witness": ("halo2_regex_tpu.witness.expand", "expand_witness"),
    "save_witness": ("halo2_regex_tpu.witness.io", "save_witness"),
    "load_witness": ("halo2_regex_tpu.witness.io", "load_witness"),
    "zoo": ("halo2_regex_tpu.models.zoo", None),
    "gen_circom": ("halo2_regex_tpu.compiler.circom", "gen_circom"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        mod = importlib.import_module(module)
        value = mod if attr is None else getattr(mod, attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "GpuScanMatcher",
    "best_matcher",
    "DistributedMatcher",
    "SeqShardedMatcher",
    "make_mesh",
    "CorpusLoader",
    "Counters",
    "check_witness_batch",
    "expand_witness",
    "save_witness",
    "load_witness",
    "zoo",
    "gen_circom",
    "AllstrRegexDef",
    "BatchMatcher",
    "CompiledRegexModel",
    "DecomposedRegexConfig",
    "RegexDefs",
    "RegexParseError",
    "RegexPartConfig",
    "RegexResult",
    "SubstrRegexDef",
    "VrmError",
    "build_all_tables",
    "check_witness",
    "compile_allstr_text",
    "dfa_to_regex_def_text",
    "extract_substrings",
    "match_substrs",
    "pack_batch",
    "parse_regex",
    "regex_to_dfa",
    "verify",
]
