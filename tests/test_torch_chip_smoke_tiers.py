"""``chip_smoke.py``'s phases 4l (``serving_mixed``) and 4m
(``serving_preempt``) rehearsed on the CPU at a narrow width, in a file of
its own so that a parallel run puts it on a worker of its own
(``--dist loadfile`` keeps a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, cpu_engine,
                                  load_chip_smoke, one_thread, recorder)

chip_smoke = load_chip_smoke()


def _narrow_model():
    """The 8B phases' model cut narrow: 2 layers, 2 heads of 128 over one
    KV head (the 8B head_dim), hidden 256, vocab 512, bf16, seeded."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    cfg = llama3_8b_config(vocab_size=512, hidden_size=256,
                           intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=2, num_key_value_heads=1)
    return LlamaForCausalLM(cfg, device="cpu", seed=0)


def _short_paged_prompts(vocab: int):
    """phase 4b's traffic cut short for a CPU run: 16 requests, 8 opening
    with one shared 512-token system prompt (4 blocks of 128) and short
    suffixes, 8 unique, alternating as ``paged_serving_prompts``."""
    import numpy as np
    rng = np.random.RandomState(2)
    system = rng.randint(0, vocab, 512).astype(np.int32)
    prompts = []
    for n_suf, n_uni in zip((5, 140, 37, 300, 12, 128, 20, 90),
                            (8, 200, 40, 64, 30, 26, 17, 90)):
        prompts.append(np.concatenate(
            [system, rng.randint(0, vocab, n_suf).astype(np.int32)]))
        prompts.append(rng.randint(0, vocab, n_uni).astype(np.int32))
    return prompts


def test_serving_mixed_and_preempt_rehearsed_on_the_cpu(monkeypatch,
                                                        one_thread):
    """Phase 4l on phase 4b's traffic cut short (eight requests sharing a
    512-token system prompt, slots of 1024, 8 new tokens) and phase 4m on
    its saturating traffic cut to a quarter (prompts of 200-275 tokens in
    a 9-block pool, max_length 512, 64-token chunks; 16 new tokens in the
    host tier's run), every sub-run included (both modes and their twins,
    the off-run, cancel in five states, the host tier, the migration, the
    float32 tiny engines): every line is emitted and only the checks that
    need the card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(chip_smoke, "PREEMPT_PROMPT_LENGTHS",
                        (250, 225, 275, 200))
    monkeypatch.setattr(chip_smoke, "PREEMPT_POOL_BLOCKS", 10)
    monkeypatch.setattr(chip_smoke, "PREEMPT_MAX_LENGTH", 512)
    monkeypatch.setattr(chip_smoke, "PREEMPT_CHUNK", 64)
    monkeypatch.setattr(chip_smoke, "MIXED_NEW_TOKENS", 8)
    monkeypatch.setattr(chip_smoke, "MIXED_MAX_LENGTH", 1024)
    monkeypatch.setattr(chip_smoke, "MIXED_MIN_DEMOTED", 4)
    monkeypatch.setattr(chip_smoke, "paged_serving_prompts",
                        _short_paged_prompts)
    monkeypatch.setattr(chip_smoke, "HOST_TIER_NEW_TOKENS", 16)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    torch = TorchOnCpu()
    model = _narrow_model()
    prompts = chip_smoke.paged_serving_prompts(model.config.vocab_size)
    paged = {"outs": [[0] * 32 for _ in prompts]}
    chip_smoke.phase_serving_mixed(torch, model, {}, paged)
    chip_smoke.phase_serving_preempt(torch, model)
    phases = [(ln["phase"], ln.get("mode") or ln.get("engine"))
              for ln in lines]
    assert phases == [
        ("serving_mixed", None), ("serving_preempt", "swap"),
        ("serving_preempt", "recompute"),
        ("serving_preempt_cancel", "swap"),
        ("serving_preempt_cancel", "recompute"),
        ("serving_host_tier", None), ("serving_migration", None)] + [
        ("model_tiny_f32_tiers", e) for e in (
            "swap", "swap chunked", "recompute", "recompute chunked",
            "mixed")]
    mixed = lines[0]
    assert mixed["demoted_block_bit_exact"] and mixed["demoted_block_changed"]
    assert mixed["kv_cache"]["quantized_blocks"] >= 4
    assert mixed["eager_twin"]["tokens_identical"]
    swap, recompute = lines[1], lines[2]
    for ln in (swap, recompute):
        assert sum(ln["preempt"]["preemptions"].values()) >= 1
        assert ln["eager_twin"]["tokens_identical"]
    assert swap["same_tokens_as_off_run"] == "4/4"
    assert min(swap["swapped_blocks_checked"]) > 0
    assert swap["host_tier"]["swap_out_bytes"] > 0
    assert all(all(ln["found"].values()) for ln in lines[3:5])
    assert lines[5]["tokens_identical_to_no_tier"]
    assert lines[5]["host_tier"]["host_promotions"] > 0
    assert lines[6]["tokens_identical"]
    assert all(ln["identical_card_vs_cpu"] for ln in lines[7:])
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"


def test_observability_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """Phase 4n on the records of phase 4b's, 4c's and 4m's swap runs cut
    short (4b / 4c: four of 4b's short requests, 4 new tokens, slots of
    1024; 4m: its saturating traffic cut to a quarter, as above): the
    line is emitted, the timelines, the registry and the cost model hold,
    and only the route checks fail (the CPU takes the plain versions)."""
    from paddle_tpu_torch.models import quantize_for_decode

    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(chip_smoke, "PREEMPT_PROMPT_LENGTHS",
                        (250, 225, 275, 200))
    monkeypatch.setattr(chip_smoke, "PREEMPT_POOL_BLOCKS", 10)
    monkeypatch.setattr(chip_smoke, "PREEMPT_MAX_LENGTH", 512)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    torch = TorchOnCpu()
    model = _narrow_model()
    vocab = model.config.vocab_size
    prompts = _short_paged_prompts(vocab)[:4]
    kw = dict(paged=True, block_len=128,
              num_blocks=chip_smoke.PAGED_POOL_BLOCKS, max_length=1024,
              new_tokens=4)
    paged = chip_smoke._serve_8b(torch, model, prompts, **kw)
    paged["eager_twin"] = chip_smoke.eager_twin(torch, model, prompts,
                                                paged, "phase 4b", **kw)
    int8 = chip_smoke._serve_8b(torch, quantize_for_decode(model), prompts,
                                kv_cache_dtype="int8", **kw)
    swap = chip_smoke.preempt_run(
        torch, model, chip_smoke.preempt_prompts(vocab), preempt="swap",
        host_blocks=chip_smoke.PREEMPT_HOST_BLOCKS)
    del swap["engine"]
    chip_smoke.phase_observability(paged, int8, swap)
    (line,) = [ln for ln in lines if ln["phase"] == "observability"]
    assert line["lifecycle_4b"]["requests"] == 4
    assert not line["lifecycle_4b"]["out_of_order"]
    assert line["lifecycle_4b"]["twin_identical"]
    assert line["lifecycle_swap"]["victims"]
    assert not line["lifecycle_swap"]["out_of_order"]
    assert not any(line["metrics_vs_registry"].values())
    assert line["perf"]["4m_swap"]["predicted_ms"]["swap_ms"] > 0
    assert line["perf"]["4b"]["profile"] == "cpu_smoke"
    assert line["chrome_trace"]["spans"]["serving.decode"] \
        == paged["metrics"]["decode_ticks"]
    assert "rms_norm/plain" in line["routes_4b"]
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert any("phase 4n" in w for w in failed), \
        "the route checks cannot pass on the CPU"
