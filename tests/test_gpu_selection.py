"""Backend selection (ops.best_matcher), device specs, timing helpers and
the compilation-cache location."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.ops import BACKENDS, best_matcher
from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher
from halo2_regex_tpu.ops.scan_jax import BatchMatcher
from halo2_regex_tpu.utils import cache, profiling

from fixtures import CONFIGS


@pytest.fixture(scope="module")
def model():
    return CompiledRegexModel.from_decomposed(
        DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=32
    )


@pytest.fixture
def on_gpu(monkeypatch):
    """best_matcher sees a GPU as the first device (nothing is compiled:
    matchers jit lazily)."""

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H200"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])


def test_backend_names():
    assert BACKENDS == ("auto", "gpu", "xla")


@pytest.mark.parametrize("columns", ["full", "witness", "match"])
def test_auto_on_gpu_picks_the_kernel(model, on_gpu, columns):
    m, name = best_matcher(model, columns=columns)
    assert name == "gpu" and isinstance(m, GpuScanMatcher)
    assert m.columns == columns and not m.interpret


def test_auto_on_gpu_takes_xla_for_a_model_the_table_cannot_hold(model, on_gpu):
    too_big = dataclasses.replace(model, s_pad=1 << 17)
    m, name = best_matcher(too_big)
    assert name == "xla" and isinstance(m, BatchMatcher)


def test_explicit_gpu_refuses_a_model_the_table_cannot_hold(model):
    too_big = dataclasses.replace(model, s_pad=1 << 17)
    with pytest.raises(ValueError, match="states"):
        best_matcher(too_big, backend="gpu", interpret=True)


@pytest.mark.parametrize("columns", ["full", "match"])
def test_auto_on_cpu_is_xla_for_every_column_set(model, columns):
    m, name = best_matcher(model, columns=columns)
    assert name == "xla" and isinstance(m, BatchMatcher)


def test_xla_refuses_witness_columns(model):
    with pytest.raises(ValueError, match="witness"):
        best_matcher(model, backend="xla", columns="witness")


def test_explicit_gpu_interpret_gives_the_kernel(model):
    m, name = best_matcher(model, backend="gpu", columns="match", interpret=True)
    assert name == "gpu" and m.interpret and m.columns == "match"
    out = m.match_one(b"from:a@b.cd\r\n")
    assert bool(out["match_ok"])


def test_cli_gpu_backend_off_gpu_is_an_error(tmp_path, capsys):
    from halo2_regex_tpu import cli

    model_path = tmp_path / "m.npz"
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CONFIGS["regex3"]))
    assert cli.main(["compile", str(cfg), "--max-chars-size", "32",
                     "-o", str(model_path)]) == 0
    rc = cli.main(["match", "--model", str(model_path), "--backend", "gpu",
                   "from:a@b.cd"])
    assert rc == 2
    assert "interpret" in capsys.readouterr().err


# ---------------------------------------------------------------- specs
class _Dev:
    platform = "gpu"

    def __init__(self, kind):
        self.device_kind = kind


def test_device_specs_h200_row():
    spec = profiling.device_specs(_Dev("NVIDIA H200"))
    assert spec["hbm_bytes_per_sec"] == 4.8e12
    assert spec["hbm_bytes"] == 141e9
    assert spec["kind"] == "NVIDIA H200"


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3", "Unlisted Accelerator"])
def test_device_specs_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published specs"):
        profiling.device_specs(_Dev(kind))


def test_scan_roofline_on_h200():
    rate = profiling.scan_roofline_bytes_per_sec(_Dev("NVIDIA H200"))
    assert rate == pytest.approx(4.8e12 / 6.0)


def test_time_calls_blocks_on_every_call():
    calls = []

    def fn(x):
        calls.append(1)
        return jax.numpy.asarray(x) + 1

    secs = profiling.time_calls(fn, np.ones(4), iters=5, warmup=2)
    assert len(secs) == 5 and len(calls) == 7 and min(secs) >= 0


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="GPU"):
        profiling.require_gpu()


def test_device_info_names_the_device():
    info = profiling.device_info()
    assert info["platform"] == "cpu" and info["device_count"] >= 1
    assert set(info) == {"platform", "device_kind", "device_count", "card"}


# ---------------------------------------------------------------- cache
@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_honours_env_var(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("H2R_NO_COMPILE_CACHE", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; the program sets no other directory
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0


def test_cache_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("H2R_NO_COMPILE_CACHE", raising=False)
    repo = Path(__file__).resolve().parents[1]
    assert cache.cache_dir() == str(repo / ".jax_cache")
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


def test_cache_can_be_disabled(monkeypatch):
    monkeypatch.setenv("H2R_NO_COMPILE_CACHE", "1")
    assert cache.cache_dir() is None
    assert cache.enable_compilation_cache() is None
