"""``chip_smoke.py``'s phase 4o (``serving_router``) rehearsed on the CPU
at a narrow width, in a file of its own so that a parallel run puts it on
a worker of its own (``--dist loadfile`` keeps a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, cpu_engine,
                                  load_chip_smoke, one_thread, recorder)

chip_smoke = load_chip_smoke()


def _narrow_model():
    """The 8B phases' model cut narrow (as the tiers' rehearsal cuts it):
    2 layers, 2 heads of 128 over one KV head, hidden 256, vocab 512,
    bf16, seeded."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    cfg = llama3_8b_config(vocab_size=512, hidden_size=256,
                           intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=2, num_key_value_heads=1)
    return LlamaForCausalLM(cfg, device="cpu", seed=0)


# the shortest trace that reaches every check: 6 requests of two tenants
# behind a one-block (128-token) system prompt, so later requests of a
# tenant find its prefix on one replica; 2-4 new tokens in 512-position
# slots
SHORT_SPEC = dict(chip_smoke.ROUTER_SPEC, n_requests=6, mean_gap=1.0,
                  prompt_buckets=(16, 32), prompt_min=8, prompt_max=32,
                  output_median=3, output_min=2, output_max=4,
                  shared_prefix_len=128)


def test_serving_router_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """Phase 4o on a short trace: the line is emitted, the twin, the
    placements, prefix affinity and the HTTP bodies hold, and only the
    checks that need the card fail (graphs, launches, routes)."""
    import paddle_tpu_torch.serving as serving
    from paddle_tpu_torch.serving import router as router_mod

    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(router_mod, "ServingEngine", serving.ServingEngine)
    monkeypatch.setattr(chip_smoke, "ROUTER_SPEC", SHORT_SPEC)
    monkeypatch.setattr(chip_smoke, "ROUTER_MAX_LENGTH", 512)
    monkeypatch.setattr(chip_smoke, "ROUTER_POOL_BLOCKS", 20)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_serving_router(TorchOnCpu(), _narrow_model())
    (line,) = lines
    assert line["phase"] == "serving_router" and line["requests"] == 6
    assert all(line["eager_twin_identical"].values())
    assert line["rejected"] == 0 and line["generated_tokens"] > 0
    assert line["prefix_routed_tokens"] > 0
    assert line["requests_by_route"].get("prefix", 0) > 0
    assert line["http"]["metrics_equal_registry"]
    assert "ok" in line["http"]["healthz"]
    assert sum(r["requests"] for r in line["per_replica"]) == 6
    assert all(r["requests"] > 0 for r in line["per_replica"])
    assert "rms_norm/plain" in line["registry_routes"]
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
