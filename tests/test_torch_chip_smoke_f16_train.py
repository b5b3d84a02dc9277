"""``chip_smoke.py``'s training_f16 phase rehearsed on the CPU at a narrow
width, in a file of its own so that a parallel run puts it on a worker of
its own (``--dist loadfile`` keeps a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, load_chip_smoke,
                                  one_thread, recorder)

chip_smoke = load_chip_smoke()

# Llama-2-7B's head_dim 128 and untied head at a narrow width
NARROW = dict(vocab_size=512, hidden_size=256, intermediate_size=256,
              num_attention_heads=2, num_key_value_heads=2)


def test_training_f16_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """training_f16 end to end on the CPU at a narrow width (2 layers, 2
    heads of 128, vocab 512, 4 x 64 tokens): O2 float16 through
    ``amp.decorate`` and a GradScaler at 2^15, the gradient gate, the 8
    steps (losses fall, the scaler's states follow its rule, every step
    taken moves the optimizer) and the overflowing step at 2^40 (skipped,
    state bit-equal, scale halved) pass; only the checks that need the
    card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    monkeypatch.setattr(chip_smoke, "F16_WIDTHS",
                        dict(chip_smoke.F16_WIDTHS, **NARROW))
    monkeypatch.setattr(chip_smoke, "LLAMA2_7B",
                        dict(chip_smoke.LLAMA2_7B, **NARROW))
    monkeypatch.setattr(chip_smoke, "TRAIN_F16_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    kernels = {n: {} for n in chip_smoke.F16_BWD}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_training_f16(TorchOnCpu(), kernels, "cpu")
    assert [ln["phase"] for ln in lines] == [
        "training_f16_grads", "training_f16", "training_f16_overflow"]
    grads, run, overflow = lines
    assert grads["head_dim"] == 128 and grads["layers"] == 2
    assert grads["grad_rel_l2_kernel_vs_f32"] <= grads["tol_kernel_vs_f32"]
    assert len(run["steps"]) == chip_smoke.TRAIN_STEPS
    assert run["losses"][-1] < run["losses"][0]
    assert not any(r["found_inf"] for r in run["steps"])
    assert {r["scale"] for r in run["steps"]} == {2.0 ** 15}
    assert [r["params_moved"] for r in run["steps"]] == (
        [False] + [True] * (chip_smoke.TRAIN_STEPS - 1))   # lr 0 at step 1
    assert overflow["found_inf"] and overflow["state_bit_equal"]
    assert overflow["scale_after"] == 2.0 ** 39
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    assert all("launches" in r for r in kernels.values())
