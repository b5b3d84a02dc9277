#!/usr/bin/env python3
"""Time the paged serving engine's decode tick at the Llama-3-8B width on
one NVIDIA GPU, for one or more checkouts of the repository in turns: the
cost of the observability layer (metrics registry, spans, request log,
cost model) against a checkout without it.

Run from the repository root::

    python3 chip_obs_overhead.py [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory holding
``paddle_tpu_torch/``, for example the parent commit unpacked with ``git
archive`` into a git-ignored directory; give A B B A to compare two in
turns on one card.  Each runs in its own process: ``chip_smoke.py``'s
phase 4b engine (Llama-3-8B at its published widths, bf16, random weights
from seed 0; 8 slots x 4096, prefill_batch 4, a 52-block pool of 128
tokens) serves phase 4b's 16 requests (8 sharing a 1536-token prompt, 32
new tokens each) twice; the second pass is timed.  It prints one JSON
line: the wall time of every ``step()`` call that ran one decode tick and
no admission wave (host clock; a tick ends in its one host fetch, so the
device work is inside) and of the engine's ``_decode`` inside it (the
tick's dispatch through its fetch; the rest is the tick's host
bookkeeping), their p50 / mean / p90 in ms, the engine's own
``decode_step_ms`` readout and, where the checkout has one, its
``perf_report()`` ratio.  The first line is the card's name and power
limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NEW_TOKENS = 32
POOL_BLOCKS = 52


def prompts(vocab: int):
    """``chip_smoke.py``'s ``paged_serving_prompts``: 8 requests opening
    with one shared 1536-token system prompt, 8 unique, alternating."""
    import numpy as np
    rng = np.random.RandomState(2)
    system = rng.randint(0, vocab, 1536).astype(np.int32)
    out = []
    for n_suf, n_uni in zip((5, 300, 37, 700, 12, 128, 1023, 90),
                            (8, 1200, 400, 64, 2000, 260, 17, 900)):
        out.append(np.concatenate(
            [system, rng.randint(0, vocab, n_suf).astype(np.int32)]))
        out.append(rng.randint(0, vocab, n_uni).astype(np.int32))
    return out


def serve(eng, reqs):
    """One pass of ``reqs``: (the wall ms of each step() that ran exactly
    one decode tick and no wave, the ms of its ``_decode``)."""
    decode = []
    inner = eng._decode

    def timed():
        t0 = time.perf_counter()
        out = inner()
        decode.append((time.perf_counter() - t0) * 1e3)
        return out

    eng._decode = timed
    for p in reqs:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    ticks, parts = [], []
    while (eng._queue or any(s is not None for s in eng._slots)):
        t, d = eng._ticks, eng._n_decode_ticks
        n = len(decode)
        t0 = time.perf_counter()
        eng.step()
        ms = (time.perf_counter() - t0) * 1e3
        if eng._ticks == t + 1 and eng._n_decode_ticks == d + 1:
            ticks.append(ms)
            parts.append(decode[n])
    eng._decode = inner
    return ticks, parts


def summary(values):
    import numpy as np
    a = np.asarray(values)
    return {"p50": round(float(np.percentile(a, 50)), 4),
            "mean": round(float(a.mean()), 4),
            "p90": round(float(np.percentile(a, 90)), 4)}


def measure(checkout: str):
    sys.path.insert(0, checkout)
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(llama3_8b_config(), device=torch.device("cuda"),
                             seed=0)
    eng = ServingEngine(model, num_slots=8, max_length=4096,
                        prefill_batch=4, paged=True, block_len=128,
                        num_blocks=POOL_BLOCKS, device="cuda")
    reqs = prompts(model.config.vocab_size)
    serve(eng, reqs)
    ticks, decode = serve(eng, reqs)
    torch.cuda.synchronize()
    out = {"checkout": checkout, "decode_ticks": len(ticks),
           "tick_ms": summary(ticks), "decode_ms": summary(decode),
           "bookkeeping_ms": summary(np.subtract(ticks, decode)),
           "engine_decode_step_ms": eng.metrics()["decode_step_ms"],
           "graphed": eng.graphed}
    rep = getattr(eng, "perf_report", None)
    if rep is not None:
        r = rep()
        out["perf"] = {k: r.get(k) for k in ("enabled", "ratio", "bounds",
                                             "drift")}
        out["perf"]["profile"] = r.get("profile", {}).get("name")
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps(measure(args[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for checkout in args or [str(ROOT)]:
        if not (Path(checkout) / "paddle_tpu_torch").is_dir():
            print(f"chip_obs_overhead: no paddle_tpu_torch/ in {checkout}",
                  file=sys.stderr)
            return 2
        r = subprocess.run([sys.executable, __file__, "--measure",
                            str(Path(checkout).resolve())],
                           capture_output=True, text=True, timeout=900)
        print(r.stdout.strip() or json.dumps(
            {"checkout": checkout, "error": r.stderr.strip()[-400:]}),
            flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
