"""``chip_smoke.py``'s serving_f16 phase rehearsed on the CPU at a narrow
width, in a file of its own so that a parallel run puts it on a worker of
its own (``--dist loadfile`` keeps a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, cpu_engine,
                                  load_chip_smoke, one_thread, recorder,
                                  short_prompts)

chip_smoke = load_chip_smoke()

# Llama-2-7B's heads of 128, one query head a KV head, cut to 2 layers of
# 4 heads and a vocab of 512
NARROW = dict(vocab_size=512, hidden_size=512, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4)


def test_serving_f16_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """serving_f16 end to end on the CPU at a narrow float16 width (head_dim
    128, G 1) on serving_f32's traffic cut short: the four engines, the
    chunked engine, ``generate``, the int8-weight engine and its
    ``generate`` run with their eager twins and truth gates, and only the
    checks that need the card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(chip_smoke, "f32_serving_prompts", short_prompts)
    # slots of 256 positions hold every short request (at most 188 + 16
    # tokens); the plain attention reads a slot's whole length
    monkeypatch.setattr(chip_smoke, "F32_L", 256)
    monkeypatch.setattr(chip_smoke, "F16_WIDTHS",
                        dict(chip_smoke.F16_WIDTHS, **NARROW))
    monkeypatch.setattr(chip_smoke, "LLAMA2_7B",
                        dict(chip_smoke.LLAMA2_7B, **NARROW))
    kernels = {n + chip_smoke.F16: {} for n in chip_smoke.F16_BUILDS}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_serving_f16(TorchOnCpu(), kernels, "cpu")
    assert [ln["engine"] for ln in lines] == [
        "contiguous", "paged", "int8_paged", "int8_contiguous", "chunked",
        "generate", "int8_weights", "generate_int8_weights"]
    assert all(ln["dtype"] == "float16" for ln in lines)
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    for ln in lines[:4] + lines[6:7]:
        g = ln["teacher_forced_logits"]
        assert g["finite"] and 0 < g["max_logit_err_kernel_vs_f32_cache"] \
            <= g["tol_kernel_vs_f32_cache"]
        assert ln["eager_twin"]["tokens_identical"]
    for ln in (lines[1], lines[6]):
        assert ln["kv_cache"]["prefix_hit_tokens"] > 0
    for ln in (lines[5], lines[7]):
        assert ln["twin_identical"] and ln["cold_identical"]
    # the K4 contract is the card's; on the CPU the projections take the
    # plain route, every one of a tick
    assert lines[6]["routes"]["int8_matmul/plain"] > 0
    assert all("launches" in r for r in kernels.values())
