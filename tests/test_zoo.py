"""Every zoo model compiles and matches correctly through the fused GPU
kernel (Pallas interpreter on the CPU) against the oracle."""

import numpy as np
import pytest

from halo2_regex_tpu.models import zoo
from halo2_regex_tpu.models.compiled import CompiledRegexModel
from halo2_regex_tpu.ops import reference as ref_ops
from halo2_regex_tpu.ops.gpu_scan import GpuScanMatcher

SAMPLES = {
    "email_from": (b"x\r\nfrom:alice@gmail.com\r\n", "alice@gmail.com"),
    "email_to": (b"x\r\nto:bob@x.yz\r\n", "bob@x.yz"),
    "email_subject": (b"x\r\nsubject:hello world\r\n", "hello world"),
    "body_prefix": (b'xx Content-Type: text/plain; charset="UTF-8"\r\n\r\n', None),
}

NEGATIVE = {
    "email_from": b"x\r\nfrom:no-at-sign\r\n",
    "email_to": b"to:bob@x.yz",  # missing CRLF
    "email_subject": b"x\r\nsubject:hello",  # missing CRLF
    "body_prefix": b"Content-Type: text/html\r\n\r\n",
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_zoo_model_gpu_kernel_vs_oracle(name):
    cfg = zoo.get_config(name, 96)
    model = CompiledRegexModel.from_decomposed(cfg, max_chars_size=96)
    m = GpuScanMatcher(model, interpret=True)
    s, expected_sub = SAMPLES[name]
    res = m.match_one(s)
    oracle = ref_ops.match_substrs(model.regex_defs, s, 96)
    for n in res.field_names():
        np.testing.assert_array_equal(
            np.asarray(getattr(res, n)).astype(np.int64),
            np.asarray(getattr(oracle, n)).astype(np.int64),
            err_msg=f"{name} field {n}",
        )
    assert bool(res.match_ok), name
    if expected_sub is not None:
        subs = ref_ops.extract_substrings(res)
        assert any(t == expected_sub for _, t, _ in subs), (name, subs)
    bad = ref_ops.match_substrs(model.regex_defs, NEGATIVE[name], 96)
    assert not bool(bad.match_ok), name


def test_email_headers_model_multi():
    model = zoo.email_headers_model(max_chars_size=96)
    m = GpuScanMatcher(model, interpret=True)
    res = m.match_one(b"x\r\nfrom:alice@gmail.com\r\n")
    # only the `from` def accepts this input
    assert np.asarray(res.accepted).tolist() == [True, False, False]
    subs = ref_ops.extract_substrings(res)
    assert subs and subs[0][1] == "alice@gmail.com"

