#!/usr/bin/env python3
"""Time the serving engine's prefill waves on one NVIDIA GPU, for one or
more checkouts of the repository in turns.

Run from the repository root::

    python3 chip_prefill_waves.py [--warmup N] [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory holding
``paddle_tpu_torch/``, for example the parent commit unpacked with ``git
archive`` into a git-ignored directory; give A B B A to compare two in
turns on one card.  Each runs in its own process and prints one JSON line
a phase.  The engines and requests are ``chip_smoke.py``'s phases 4
(contiguous bf16), 4b (paged bf16, 52-block pool), 4c (4b with int8 KV
and int8 weights) and 4d (4 with int8 KV and int8 weights) at the full
Llama-3-8B width (32 layers, random weights from seed 0): 8 slots,
``max_length`` 4096, ``prefill_batch`` 4, 32 new tokens a request.  Each
phase serves its requests once on a new engine (``cold``: a checkout that
builds its prefill waves builds them inside this pass), and phases 4 and
4d serve them again on the same engine (``warm``), then once more with
every wave inside its own ``torch.profiler`` session (``profiled``, CUDA
activity only).  A pass reports tok/s, TTFT and ``prefill_wave_ms`` (the
engine's own percentiles, this pass's waves only), its waves' wall ms
summed, the peak of ``torch.cuda.max_memory_allocated`` over the pass,
and where the engine has them ``prefill_traces`` and
``prefill_graph_replays``; the profiled pass gives each wave's device
kernel time (the sum of the kernels its session saw) beside its wall
time under the profiler.  A cold pass also gives each prefill-key
build's ms (``build_ms``: the whole build, and its ``gc.collect()``,
the recording of the capture and the graph's instantiation).

``--warmup N`` sets the eager runs a new prefill key takes before its
capture (``serving.step_graph.PrefillStep.WARMUP``; a checkout without it
is run as it is), and adds each pass's token comparison with an eager
twin of the engine (``disable_graphs()``).  The first line is the card's
name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAGED = dict(paged=True, block_len=128, num_blocks=52)
INT8 = dict(kv_cache_dtype="int8", int8_weights=True)
# phase -> (engine options, paged requests, warm and profiled passes)
PHASES = {"4": ({}, False, True), "4b": (PAGED, True, False),
          "4c": (dict(PAGED, **INT8), True, False),
          "4d": (INT8, False, True)}


def _smoke():
    """``chip_smoke.py`` of this checkout as a module, for its requests
    (it imports nothing of the package at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(xs):
    import numpy as np
    if not xs:
        return {"count": 0}
    a = np.asarray(xs)
    return {"count": len(xs), "sum": round(float(a.sum()), 3),
            "p50": round(float(np.percentile(a, 50)), 3),
            "max": round(float(a.max()), 3)}


def _pass(torch, smoke, eng, prompts, profiled=False):
    """One pass of ``prompts`` through ``eng`` (``chip_smoke.py``'s
    ``_serve_pass``: this pass's counters and latencies), each wave timed:
    wall ms and, ``profiled``, device kernel ms.  Returns (its line, the
    outputs, each wave's wall ms)."""
    from torch.profiler import ProfilerActivity, profile
    waves = []
    real = {n: getattr(eng, n) for n in ("_prefill", "_prefill_paged")}

    def timed(fn):
        def wave(*args, **kwargs):
            t0 = time.perf_counter()
            if not profiled:
                out = fn(*args, **kwargs)
                waves.append(((time.perf_counter() - t0) * 1e3, None))
                return out
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            dev = sum(t for t, _, _ in smoke.kernel_rows(prof)) / 1e3
            waves.append(((time.perf_counter() - t0) * 1e3, dev))
            return out
        return wave

    for n, fn in real.items():
        setattr(eng, n, timed(fn))
    try:
        run = smoke._serve_pass(torch, eng, prompts, 32, [])
    finally:
        for n, fn in real.items():
            setattr(eng, n, fn)
    m = run["metrics"]
    ntok = sum(len(o) for o in run["outs"])
    line = {"tok_per_s": round(ntok / run["wall"], 2),
            "wall_s": round(run["wall"], 4),
            "prefill_waves": m["prefill_waves"],
            "decode_ticks": m["decode_ticks"],
            "peak_memory_gb": run["peak_memory_gb"],
            "ttft_ms": m["ttft_ms"], "prefill_wave_ms": m["prefill_wave_ms"],
            "wave_wall_ms": _summary([w for w, _ in waves])}
    if profiled:
        line["wave_device_kernel_ms"] = _summary([d for _, d in waves])
    for k in ("prefill_traces", "prefill_graph_replays"):
        if k in m:
            line[k] = m[k]
    return line, run["outs"], [round(w, 2) for w, _ in waves]


def _time_builds(torch, step_graph):
    """Time every prefill-key build of this process (a checkout with
    ``PrefillStep``): the whole build, and in it the ``gc.collect()``
    before the capture, the recording of the capture (``capture_begin``
    returned to ``capture_end`` called) and the graph's instantiation
    (``capture_end``).  Returns the lists, in ms, filled as builds run."""
    times = {"build": [], "gc_collect": [], "record": [], "instantiate": []}
    cls = getattr(step_graph, "PrefillStep", None)
    if cls is None:
        return times
    state = {"in": False, "begun": 0.0}

    def wrap(fn, name, build=False):
        def timed(*args, **kwargs):
            if not (state["in"] or build):
                return fn(*args, **kwargs)
            if name == "instantiate":
                times["record"].append(
                    round((time.perf_counter() - state["begun"]) * 1e3, 2))
            if build:
                torch.cuda.synchronize()
                state["in"] = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if build:
                    torch.cuda.synchronize()
                    state["in"] = False
                t1 = time.perf_counter()
                if name == "begin":
                    state["begun"] = t1
                else:
                    times[name].append(round((t1 - t0) * 1e3, 2))
        return timed

    cls._build = wrap(cls._build, "build", build=True)
    gc.collect = wrap(gc.collect, "gc_collect")
    graph = torch.cuda.CUDAGraph
    graph.capture_begin = wrap(graph.capture_begin, "begin")
    graph.capture_end = wrap(graph.capture_end, "instantiate")
    return times


def measure(checkout: str, warmup) -> None:
    sys.path.insert(0, checkout)
    import torch
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama3_8b_config,
                                         quantize_for_decode)
    from paddle_tpu_torch.serving import ServingEngine, step_graph

    if warmup is not None and hasattr(step_graph, "PrefillStep"):
        step_graph.PrefillStep.WARMUP = warmup
    smoke = _smoke()
    builds = _time_builds(torch, step_graph)
    dev = torch.device("cuda")
    model = LlamaForCausalLM(llama3_8b_config(), device=dev, seed=0)
    qmodel = quantize_for_decode(model)
    vocab = model.config.vocab_size
    for phase, (kw, paged, again) in PHASES.items():
        prompts = (smoke.paged_serving_prompts(vocab) if paged
                   else smoke.serving_prompts(vocab))
        m = qmodel if kw.get("int8_weights") else model
        eng = ServingEngine(m, num_slots=8, max_length=4096,
                            prefill_batch=4, device="cuda", **kw)
        line = {"checkout": checkout, "phase": phase,
                "warmup": getattr(getattr(step_graph, "PrefillStep", None),
                                  "WARMUP", None)}
        t0 = time.perf_counter()
        line["cold"], outs, each = _pass(torch, smoke, eng, prompts)
        line["cold"]["wave_ms_each"] = each
        line["cold"]["build_ms"] = {k: v[:] for k, v in builds.items()}
        for v in builds.values():
            del v[:]
        line["cold"]["seconds"] = round(time.perf_counter() - t0, 3)
        runs = [outs]
        if again:
            line["warm"], warm, _ = _pass(torch, smoke, eng, prompts)
            line["profiled"], profiled, _ = _pass(torch, smoke, eng,
                                                  prompts, profiled=True)
            runs += [warm, profiled]
        line["same_tokens_across_passes"] = all(o == outs for o in runs)
        del eng
        if warmup is not None:
            with step_graph.disable_graphs():
                twin = ServingEngine(m, num_slots=8, max_length=4096,
                                     prefill_batch=4, device="cuda", **kw)
            _, eager, _ = _pass(torch, smoke, twin, prompts)
            line["tokens_identical_to_eager"] = eager == outs
            del twin
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    warmup = None
    if args[:1] == ["--warmup"]:
        warmup, args = int(args[1]), args[2:]
    if args[:1] == ["--measure"]:
        measure(args[1], warmup)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_prefill_waves: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for checkout in args or [str(ROOT)]:
        if not (Path(checkout) / "paddle_tpu_torch").is_dir():
            print(f"chip_prefill_waves: no paddle_tpu_torch/ in {checkout}",
                  file=sys.stderr)
            return 2
        cmd = [sys.executable, __file__]
        if warmup is not None:
            cmd += ["--warmup", str(warmup)]
        r = subprocess.run(cmd + ["--measure", str(Path(checkout).resolve())],
                           capture_output=True, text=True, timeout=900)
        print(r.stdout.strip(), flush=True)
        if r.returncode:
            print(json.dumps({"checkout": checkout, "rc": r.returncode,
                              "error": r.stderr.strip()[-1500:]}),
                  flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
