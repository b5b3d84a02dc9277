"""``chip_smoke.py``'s training_d256 phase rehearsed on the CPU at a
narrow width, in a file of its own so that a parallel run puts it on a
worker of its own (``--dist loadfile`` keeps a file on one worker)."""

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import (CARD_ONLY, TorchOnCpu, load_chip_smoke,
                                  one_thread, recorder)

chip_smoke = load_chip_smoke()


def test_training_d256_rehearsed_on_the_cpu(monkeypatch, one_thread):
    """training_d256 end to end on the CPU at a narrow width (2 layers, 8
    heads of 256 over one KV head, vocab 512, 4 x 64 tokens): the gradient
    gate and the 8 steps run, the losses fall, and only the checks that
    need the card fail."""
    failed, record = recorder()
    monkeypatch.setattr(chip_smoke, "check", record)
    monkeypatch.setattr(chip_smoke, "GEMMA2B_WIDTHS", dict(
        chip_smoke.GEMMA2B_WIDTHS, vocab_size=512, intermediate_size=256,
        num_hidden_layers=2))
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    kernels = {n: {} for n in chip_smoke.BF16_D256_BWD}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_training_d256(TorchOnCpu(), kernels, "cpu")
    assert [ln["phase"] for ln in lines] == ["training_d256_grads",
                                             "training_d256"]
    grads, run = lines
    assert grads["head_dim"] == 256 and grads["layers"] == 2
    assert grads["grad_rel_l2_kernel_vs_f32"] <= grads["tol_kernel_vs_f32"]
    assert len(run["losses"]) == chip_smoke.TRAIN_STEPS
    assert run["losses"][-1] < run["losses"][0]
    assert run["optimizer_state_bytes"] > 0
    bad = [w for w in failed if not any(k in w for k in CARD_ONLY)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    assert all("launches" in r for r in kernels.values())
