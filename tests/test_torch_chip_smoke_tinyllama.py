"""``chip_smoke.py``'s serving_tinyllama phase rehearsed on the CPU at a
narrow width, in a file of its own so that a parallel run puts it on a
worker of its own (``--dist loadfile`` keeps a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, cpu_engine,
                                  load_chip_smoke, one_thread, recorder,
                                  short_prompts)

chip_smoke = load_chip_smoke()


def test_serving_tinyllama_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """serving_tinyllama end to end on the CPU at a narrow width (2 layers,
    8 heads of 64 over one KV head, vocab 512) on serving_f32's traffic
    cut short (8 requests of 5..188 tokens, 4 sharing a 128-token prompt,
    in slots of 256 positions):
    every engine, its eager twin, the teacher-forced truth gate, the
    chunked engine and ``generate`` run, and only the checks that need the
    card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(chip_smoke, "f32_serving_prompts", short_prompts)
    # slots of 256 positions hold every short request (at most 188 + 16
    # tokens); the plain attention reads a slot's whole length
    monkeypatch.setattr(chip_smoke, "F32_L", 256)
    monkeypatch.setattr(chip_smoke, "TINYLLAMA", dict(
        chip_smoke.TINYLLAMA, vocab_size=512, hidden_size=512,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=1))
    kernels = {n + chip_smoke.BF16_D64: {}
               for n in chip_smoke.BF16_D64_BUILDS}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_serving_tinyllama(TorchOnCpu(), kernels, "cpu")
    assert [ln["engine"] for ln in lines] == [
        "contiguous", "paged", "int8_paged", "int8_contiguous", "chunked",
        "generate"]
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    for ln in lines[:4]:
        g = ln["teacher_forced_logits"]
        assert g["finite"] and 0 < g["max_logit_err_kernel_vs_f32_cache"] \
            <= g["tol_kernel_vs_f32_cache"]
        assert ln["eager_twin"]["tokens_identical"]
    assert lines[1]["kv_cache"]["prefix_hit_tokens"] > 0
    assert lines[5]["twin_identical"] and lines[5]["cold_identical"]
    assert all("launches" in r for r in kernels.values())
