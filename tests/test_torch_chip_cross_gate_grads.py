"""Host-side parts of ``chip_cross_gate_grads.py`` (the study of Qwen2-VL's
cross-gate gradient errors on the card), on the CPU: the plain attention
with K2's rounding of P, one seed's line with the plain version on both
sides, the summary's ranges, and the exit without a card."""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.models import tiny_qwen2_vl_config
from paddle_tpu_torch.ops import attention

_SPEC = importlib.util.spec_from_file_location(
    "chip_cross_gate_grads",
    Path(__file__).resolve().parents[1] / "chip_cross_gate_grads.py")
study = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(study)


@pytest.mark.parametrize("causal", [False, True])
def test_p_rounding_changes_only_the_bf16_forward(causal):
    """Inside the context the plain attention rounds P to the inputs'
    dtype: at float32 nothing changes (1e-6), at bf16 the output moves by
    at most bf16 rounding and the gradient still reaches q, k and v; the
    plain version is restored on exit."""
    saved = attention.flash_attention_reference
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, s, h, 16, generator=g)
               for s, h in ((5, 4), (7, 2), (7, 2)))
    want = attention.flash_attention_reference(q, k, v, causal=causal)
    with study.p_rounded_to_bf16(torch):
        got = attention.flash_attention_reference(q, k, v, causal=causal)
        qb, kb, vb = (t.bfloat16().requires_grad_() for t in (q, k, v))
        out16 = attention.flash_attention_reference(qb, kb, vb,
                                                    causal=causal)[0]
        grads = torch.autograd.grad(out16.float().sum(), (qb, kb, vb))
    assert attention.flash_attention_reference is saved
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    ref16 = saved(qb.detach(), kb.detach(), vb.detach(), causal=causal)[0]
    assert float((out16.float() - ref16.float()).abs().max()) <= 2 ** -6
    assert all(float(t.abs().sum()) > 0 for t in grads)


def test_seed_line_on_the_cpu():
    """With the plain version on both sides (the CPU) the kernel and
    plain paths read the same; every field is present and the
    cancellation lies in (0, 1]."""
    cfg = dataclasses.replace(tiny_qwen2_vl_config(), dtype="bfloat16")
    line = study.model_seed(torch, 0, "cpu", cfg)
    gates = {"cross.0.gate", "cross.1.gate"}
    assert line["phase"] == "seed" and set(line["cancellation"]) == gates
    assert all(0 < c <= 1 for c in line["cancellation"].values())
    assert line["kernel"] == line["plain"]
    assert set(line["plain_p16"]["gates"]) == gates


def test_summary_reports_each_ratio_range():
    def seed(k, p, q):
        return {"kernel": {"gates": {"g": k}, "summed_rel_l2": k},
                "plain": {"gates": {"g": p}, "summed_rel_l2": p},
                "plain_p16": {"gates": {"g": q}, "summed_rel_l2": q},
                "cancellation": {"g": k / 10}}

    attn = [{t: {n: x for n in ("out", "dq", "dk", "dv")}
             for t, x in (("kernel", 2.0), ("plain", 1.0),
                          ("plain_p16", 4.0))}]
    out = study.summary([seed(0.1, 0.05, 0.2), seed(0.3, 0.3, 0.1)], attn)
    assert out["g"]["kernel/plain"] == [1.0, 2.0]
    assert out["g"]["kernel/plain_p16"] == pytest.approx([0.5, 3.0])
    assert out["g"]["kernel"] == [0.1, 0.3]
    assert out["summed kernel/plain"] == [1.0, 2.0]
    assert out["attention dv kernel/plain_p16"] == [0.5, 0.5]


def test_exits_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert study.main([]) == 2
    assert capsys.readouterr().out == ""
