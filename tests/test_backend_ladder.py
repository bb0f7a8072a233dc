"""ops.best_matcher backend selection (the CLI/bench entry point)."""

import numpy as np
import pytest

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.ops import best_matcher

from fixtures import CONFIGS


@pytest.fixture(scope="module")
def model():
    return CompiledRegexModel.from_decomposed(
        DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=32
    )


def test_auto_on_cpu_is_xla(model):
    m, name = best_matcher(model)
    assert name == "xla"
    res = m.match_one(b"from:a@b.cd\r\n")
    assert bool(np.asarray(res.match_ok))


def test_unknown_backend_raises(model):
    with pytest.raises(ValueError):
        best_matcher(model, backend="cuda")


def test_explicit_gpu_interpret_matches_xla(model):
    mg, name = best_matcher(model, backend="gpu", interpret=True)
    assert name == "gpu"
    mx, _ = best_matcher(model, backend="xla")
    line = b"from:a@b.cd\r\n"
    a, b = mg.match_one(line), mx.match_one(line)
    assert (np.asarray(a.masked_characters) == np.asarray(b.masked_characters)).all()
    assert bool(np.asarray(a.match_ok)) == bool(np.asarray(b.match_ok))


def test_explicit_gpu_off_gpu_raises(model):
    with pytest.raises(ValueError, match="interpret"):
        best_matcher(model, backend="gpu")
