"""What the CPU rehearsals of ``chip_smoke.py``'s card phases share: the
script loaded as a module, ``torch`` with ``device("cuda")`` the CPU and
the ``torch.cuda`` calls the phases make stubbed, a recorder in place of
the script's ``check``, and the checks only the card can pass (a CPU run
takes the plain versions, eagerly)."""

import importlib.util
from pathlib import Path

import pytest
import torch


def load_chip_smoke():
    """``chip_smoke.py`` of this checkout as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cuda:
    """torch.cuda's calls the serving phases make, on a CPU-only host."""

    @staticmethod
    def synchronize():
        pass

    empty_cache = reset_peak_memory_stats = synchronize

    @staticmethod
    def max_memory_allocated():
        return 0


class TorchOnCpu:
    """``torch`` with ``device("cuda")`` the CPU and the stubs above."""

    cuda = Cuda

    @staticmethod
    def device(*args):
        return torch.device("cpu")

    def __getattr__(self, name):
        return getattr(torch, name)


# what a CPU run of a card phase must fail: the kernel, graph and route
# checks (the CPU runs the plain versions, eagerly)
CARD_ONLY = ("graph", "launch", "replays", "plain route", "RMSNorm kernel",
             "attention kernels off")


@pytest.fixture
def one_thread():
    """The rehearsal on one intra-op thread: its tensors are small, and in
    a parallel run (six workers on the host's cores) workers that each
    take every core oversubscribe them, a rehearsal then running several
    times longer than alone.  The thread count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recorder():
    """(failed, record): ``record(cond, what)`` stands in for the script's
    ``check`` and appends each failed ``what`` to ``failed``."""
    failed = []

    def record(cond, what):
        if not cond:
            failed.append(what)
    return failed, record


def cpu_engine(monkeypatch):
    """Every ``ServingEngine`` the phase builds, on the CPU."""
    import paddle_tpu_torch.serving as serving

    class CpuEngine(serving.ServingEngine):
        def __init__(self, model, **kw):
            super().__init__(model, **dict(kw, device="cpu"))

    monkeypatch.setattr(serving, "ServingEngine", CpuEngine)


def short_prompts(vocab: int):
    """serving_f32's traffic cut short for a CPU run: 8 requests of 5..188
    prompt tokens, 4 opening with one shared 128-token system prompt (two
    64-token blocks, so the paged engines' prefix cache hits), the kinds
    alternating in arrival order, as ``f32_serving_prompts``."""
    import numpy as np
    rng = np.random.RandomState(17)
    system = rng.randint(0, vocab, 128).astype(np.int32)
    prompts = []
    for n_suf, n_uni in zip((5, 30, 17, 60), (5, 10, 70, 150)):
        prompts.append(np.concatenate(
            [system, rng.randint(0, vocab, n_suf).astype(np.int32)]))
        prompts.append(rng.randint(0, vocab, n_uni).astype(np.int32))
    return prompts
