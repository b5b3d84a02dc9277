"""``chip_smoke.py``'s serving_f32_tinyllama and training_f32_d256 phases
rehearsed on the CPU at narrow widths, in a file of their own so that a
parallel run puts them on a worker of their own (``--dist loadfile`` keeps
a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, cpu_engine,
                                  load_chip_smoke, one_thread, recorder,
                                  short_prompts)

chip_smoke = load_chip_smoke()


def test_serving_f32_tinyllama_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """serving_f32_tinyllama end to end on the CPU at a narrow float32
    width (2 layers, 8 heads of 64 over one KV head, vocab 512) on
    serving_f32's traffic cut short (8 requests of 5..188 tokens, 4 sharing
    a 128-token prompt, 4 new tokens each, in slots of 256 positions;
    ``generate`` over 16-token prompts): the four engines with their eager
    twins and float32 logit gates, the chunked engine and ``generate``
    run, and only the checks that need the card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(chip_smoke, "f32_serving_prompts", short_prompts)
    monkeypatch.setattr(chip_smoke, "F32_L", 256)
    monkeypatch.setattr(chip_smoke, "F32_NEW_TOKENS", 4)
    monkeypatch.setattr(chip_smoke, "GEN_PROMPT", 16)
    monkeypatch.setattr(chip_smoke, "GEN_NEW", 4)
    monkeypatch.setattr(chip_smoke, "TINYLLAMA", dict(
        chip_smoke.TINYLLAMA, vocab_size=512, hidden_size=512,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=1))
    kernels = {n + chip_smoke.F32: {} for n in chip_smoke.F32_SERVING_BUILDS}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_serving_f32_tinyllama(TorchOnCpu(), kernels, "cpu")
    assert [ln["engine"] for ln in lines] == [
        "contiguous", "paged", "int8_paged", "int8_contiguous", "chunked",
        "generate"]
    assert all(ln["dtype"] == "float32" for ln in lines)
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    for ln in lines[:4]:
        g = ln["teacher_forced_logits"]
        # the float32 gate: kernel path against plain path (one path on the
        # CPU), the int8 caches' also against the float32 cache
        assert g["finite"] and g["max_logit_diff_kernel_vs_plain"] <= g["tol"]
        assert ("tol_kernel_vs_f32_cache" in g) == ln["engine"].startswith(
            "int8")
        assert ln["eager_twin"]["tokens_identical"]
    assert lines[1]["kv_cache"]["prefix_hit_tokens"] > 0
    assert lines[5]["twin_identical"] and lines[5]["cold_identical"]
    assert all("launches" in r for r in kernels.values())


def test_training_f32_d256_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """training_f32_d256 end to end on the CPU at a narrow float32 width (2
    layers, 8 heads of 256 over one KV head, vocab 512, 4 x 64 tokens): the
    float32 gradient gate and TRAIN_F32_STEPS steps run, the losses fall,
    and only the checks that need the card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    monkeypatch.setattr(chip_smoke, "GEMMA2B_WIDTHS", dict(
        chip_smoke.GEMMA2B_WIDTHS, vocab_size=512, intermediate_size=256,
        num_hidden_layers=2))
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    kernels = {n: {} for n in chip_smoke.F32_BWD
               + ("flash_attention_fwd" + chip_smoke.F32,)}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_training_f32_d256(TorchOnCpu(), kernels, "cpu")
    assert [ln["phase"] for ln in lines] == ["training_f32_d256_grads",
                                             "training_f32_d256"]
    grads, run = lines
    assert grads["head_dim"] == 256 and grads["layers"] == 2
    assert grads["finite"] and grads["loss_rel_diff"] <= 1e-5
    assert grads["max_grad_diff_over_tensor_max"] <= grads["tol"]
    assert len(run["losses"]) == chip_smoke.TRAIN_F32_STEPS
    assert run["losses"][-1] < run["losses"][0]
    assert run["optimizer_state_bytes"] > 0
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    assert all("launches" in r for r in kernels.values())
