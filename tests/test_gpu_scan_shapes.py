"""The fused GPU scan kernel on batches that are not whole blocks and
on short and odd lengths (Pallas interpreter), bit-exact vs the oracle and
the XLA path."""

import numpy as np
import pytest

from halo2_regex_tpu.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.ops import gpu_scan
from halo2_regex_tpu.ops import reference as ref_ops
from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher
from halo2_regex_tpu.ops.scan_jax import BatchMatcher, pack_batch

from fixtures import CONFIGS


@pytest.mark.parametrize("B", [1, gpu_scan.BLOCK - 1, gpu_scan.BLOCK + 1,
                               3 * gpu_scan.BLOCK])
@pytest.mark.parametrize("Lr", [1, 17, 64])
def test_ragged_shapes_vs_oracle(B, Lr):
    """Batches that are not whole blocks, lengths 0..L (0 and L included)."""
    model = CompiledRegexModel.from_decomposed(
        DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=Lr
    )
    rng = np.random.default_rng(B * 100 + Lr)
    pool = [b"from:a@b.cd\r\n", b"dummy\r\nfrom:alice@gmail.com\r\n", b"zz"]
    strings = []
    for i in range(B):
        n = [0, Lr][i % 2] if i < 2 else int(rng.integers(0, Lr + 1))
        base = pool[i % len(pool)]
        strings.append((base * (1 + Lr // len(base)))[:n])
    chars, lengths = pack_batch(strings, Lr)
    res = GpuScanMatcher(model, interpret=True)(chars, lengths).map(np.asarray)
    assert res.states.shape == (B, 1, Lr + 1)
    check = range(B) if B < 8 else sorted({0, 1, B // 2, B - 2, B - 1})
    for i in check:
        oracle = ref_ops.match_substrs(model.regex_defs, strings[i], Lr)
        for name in oracle.field_names():
            np.testing.assert_array_equal(
                getattr(res, name)[i].astype(np.int64),
                np.asarray(getattr(oracle, name)).astype(np.int64),
                err_msg=f"row {i} field {name}",
            )
    ref = BatchMatcher(model)(chars, lengths)
    for name in ref.field_names():
        np.testing.assert_array_equal(
            getattr(res, name), np.asarray(getattr(ref, name)), err_msg=name
        )
