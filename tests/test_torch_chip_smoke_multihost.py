"""``chip_smoke.py``'s phase 4p (``serving_multihost``) rehearsed on the
CPU at a narrow width, in a file of its own so that a parallel run puts it
on a worker of its own (``--dist loadfile`` keeps a file on one worker)."""

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


# the shortest trace that reaches every check: 4 requests of two tenants
# behind a one-block (128-token) system prompt, 16-32 more tokens (two
# blocks to migrate), 3-5 new tokens; d1 is killed from tick 2 on
SHORT_SPEC = dict(chip_smoke.MULTIHOST_SPEC, n_requests=4, mean_gap=1.0,
                  prompt_buckets=(16, 32), prompt_min=8, prompt_max=32,
                  output_median=4, output_min=3, output_max=5)


def test_serving_multihost_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """Phase 4p on a short trace, the self-check in worker processes on
    the CPU: the line is emitted, the twin, placements, migrations and
    their bytes, the failover leg, federation, HTTP and the stream hold,
    and only the checks that need the card fail (graphs, launches,
    routes)."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    cpu_engine(monkeypatch)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_SPEC", SHORT_SPEC)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_MAX_LENGTH", 512)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_POOL_BLOCKS", 16)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_KILL_TICK", 2)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_SELFCHECK_ARGS",
                        ("--device", "cpu"))
    monkeypatch.setattr(chip_smoke, "MULTIHOST_SELFCHECK_TIMEOUT", 120)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_serving_multihost(TorchOnCpu(), _narrow_model(),
                                       "cpu")
    (line,) = lines
    assert line["phase"] == "serving_multihost" and line["requests"] == 4
    assert all(line["eager_twin_identical"].values())
    assert line["rejected"] == 0 and line["generated_tokens"] > 0
    assert line["migrations"] == 4
    assert line["migration_bytes"] == (sum(line["migrated_blocks"])
                                       * line["block_bytes"])
    assert line["per_worker"]["p0"]["prefill_waves"] > 0
    assert all(line["per_worker"][n]["prefill_waves"] == 0
               for n in ("d0", "d1"))
    assert line["failover"]["victims"] and line["failover"]["failovers"]
    assert line["federation"]["stitched_request_slices"] > 0
    assert line["http"]["stream_tokens"] == 8
    assert line["selfcheck"]["rc"] == 0 and line["selfcheck"]["passed"]
    assert "rms_norm/plain" in line["registry_routes"]
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
