#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds every kernel of the serving path from the sources in the
checkout, holds each against its plain PyTorch version, runs the model at
the full Llama-3-8B width and serves requests through the engine.  Every
phase prints one JSON line; any failed check raises, so the script exits
non-zero.  Phases:

  1. card      — ``nvidia-smi`` name and power limit, torch/CUDA versions,
                 the kernels' build time (one ``nvcc`` per source, all at
                 once) and ptxas's registers / spill bytes per library;
  2. kernels   — K1 flash-decode, K2 flash-attention forward and K3
                 RMSNorm at the serving path's Llama-3-8B shapes (bf16):
                 max error against the plain version beside the stated
                 tolerance, kernel / plain / library / bound times in ms;
  3. model     — ``LlamaForCausalLM(llama3_8b_config())``, 32 layers,
                 random weights from a seeded ``torch.Generator``:
                 teacher-forced ``decode_step`` (prefill + 4 decode steps)
                 with the kernels, under ``reference_mode()``, and on a
                 float32 copy of the weights (the truth); the kernel path's
                 logit error against the truth must be within the stated
                 tolerance of the plain path's; then a tiny float32
                 engine on the card (kernels) against the same engine on
                 the CPU (plain versions): greedy tokens must be identical;
  4. serving   — ``ServingEngine(num_slots=8, max_length=4096,
                 prefill_batch=4)`` on 12 requests of 5..1500 prompt
                 tokens, 32 new tokens each; every launch counter is reset
                 just before and read just after; tok/s, step ms, TTFT.

Then the ``{"kernels": [...]}`` line (launches from phase 4; error and
times from phase 2) and, last, ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler window over a few decode ticks after
phase 4 (kernel time by name, device busy share) for PERF.md.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores

KERNEL_INFO = {
    "decode_attention": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:128"},
    "rms_norm": {
        "route": "triton",
        "source": "paddle_tpu_torch/ops/triton/rms_norm.py",
        "replaces": "paddle_tpu/ops/pallas/rms_norm.py:32"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# -- timing ---------------------------------------------------------------------

def time_ms(torch, fns, budget_ms: float = 300.0) -> float:
    """Mean time of one call, by CUDA events around a run of calls: the
    device time, or the host's enqueue time where the host is slower.
    ``fns`` is a list of closures over different input copies, cycled so a
    call finds its inputs outside the 50 MB L2 cache, as the serving path
    does."""
    return _time(torch, fns, budget_ms)[0]


def host_ms(torch, fns) -> float:
    """Mean host time to enqueue one call (Python + launch), same loop."""
    return _time(torch, fns, 100.0)[1]


def _time(torch, fns, budget_ms):
    fns[0]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    est = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(200, max(5, budget_ms / est)))
    for f in fns:
        f()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    t_host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, t_host


def copies(nbytes: int) -> int:
    """Input copies to cycle so that consecutive calls miss L2."""
    return int(min(8, max(1, math.ceil(150e6 / max(nbytes, 1)))))


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def within(a, b, atol: float, rtol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all().item())


# -- phase 1 ------------------------------------------------------------------------

def phase_card(torch, pt_build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    pt_build.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, log in pt_build.build_log.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        ptxas[name] = {"max_registers": max(regs, default=None),
                       "spill_store_bytes": sum(spills)}
    emit({"phase": "card", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc_build_s": round(build_s, 3), "ptxas": ptxas})
    return card


# -- phase 2 ------------------------------------------------------------------------

def phase_kernels(torch):
    from paddle_tpu_torch.ops import (cached_decode_attention,
                                      cached_decode_attention_reference,
                                      flash_attention,
                                      flash_attention_reference, rms_norm,
                                      rms_norm_reference)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}

    def tols(dt):
        # bf16 output: 2^-8 relative, f32 inside; float32: sum order only
        return (1e-2, 1e-2) if dt == bf16 else (1e-5, 1e-5)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def record(name, shape, err, tol, ok, kfns, plain_ms, lib_ms, bms, by,
               main):
        ms, hms = time_ms(torch, kfns), host_ms(torch, kfns)
        row = {"phase": "kernels", "kernel": name, "shape": shape,
               "max_err": err, "tol": tol, "ok": ok, "kernel_ms": ms,
               "host_ms": hms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
               "bound_by": by}
        emit(row)
        check(ok, f"{name} {shape}: max error {err} beyond {tol}")
        agg = results.setdefault(name, {"max_abs_err": 0.0})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        if main:
            agg.update(shape=shape, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms)

    # ---- K1 flash-decode: the decode tick's shape (bf16, head_dim 128),
    # then the tiny model's float32 build (head_dim 16) ----------------------
    for dt, hq, hkv, d, b, s, L, pos_list, main in (
            (bf16, 32, 8, 128, 8, 1, 4096,
             [0, 4095, 17, 1000, 2047, 3000, 511, 128], True),
            (bf16, 32, 8, 128, 2, 4, 1024, [0, 700], False),
            (f32, 4, 2, 16, 2, 1, 64, [0, 40], False),
            (f32, 4, 2, 16, 2, 3, 64, [5, 60], False)):
        atol, rtol = tols(dt)
        esz = 2 if dt == bf16 else 4
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        nb = b * L * hkv * d * esz * 2
        sets = []
        for _ in range(copies(nb)):
            sets.append((randn(b, s, hq, d, dtype=dt),
                         randn(b, L, hkv, d, dtype=dt),
                         randn(b, L, hkv, d, dtype=dt)))
        q, kc, vc = sets[0]
        got = cached_decode_attention(q, kc, vc, pos)
        want = cached_decode_attention_reference(q, kc, vc, pos)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        kfns = [lambda t=t: cached_decode_attention(*t, pos) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: cached_decode_attention(*t, pos) for t in sets])
        # library yardstick: one SDPA call over the whole cache with the
        # per-row causal mask (reads all L keys; the kernel reads the live
        # prefix only)
        kj = torch.arange(L, device=dev)
        qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
        mask = (kj[None, None] <= qi[:, :, None])[:, None]      # B,1,s,L
        lib_ms = time_ms(torch, [
            lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
            for t in sets])
        live = [min(L, p + s) for p in pos_list]
        nbytes = (2 * b * s * hq * d * esz + sum(live) * hkv * d * esz * 2
                  + 4 * b)
        ops = sum(4 * d * hq * (p + si + 1)
                  for p in pos_list for si in range(s))
        bms, by = bound(nbytes, ops, BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record("decode_attention",
               f"B={b} s={s} L={L} Hq={hq} Hkv={hkv} D={d} pos={pos_list} "
               f"{str(dt)[6:]}",
               err, f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms, lib_ms,
               bms, by, main)
        del sets, q, kc, vc, got, want

    # ---- K2 flash-attention forward: the prefill wave's shapes (bf16,
    # head_dim 128), then the tiny model's float32 build (head_dim 16) -------
    for dt, hq, hkv, d, b, sq, skv, main in (
            (bf16, 32, 8, 128, 4, 8, 8, False),
            (bf16, 32, 8, 128, 4, 100, 100, False),
            (bf16, 32, 8, 128, 4, 512, 512, False),
            (bf16, 32, 8, 128, 4, 2048, 2048, True),
            (bf16, 32, 8, 128, 4, 100, 612, False),
            (bf16, 32, 8, 128, 2, 128, 64, False),
            (f32, 4, 2, 16, 2, 32, 32, False),
            (f32, 4, 2, 16, 2, 70, 100, False),
            (f32, 4, 2, 16, 2, 24, 8, False)):
        atol, rtol = tols(dt)
        lse_tol = 1e-3 if dt == bf16 else 1e-5
        esz = 2 if dt == bf16 else 4
        nb = b * (sq * hq + 2 * skv * hkv) * d * esz
        sets = [(randn(b, sq, hq, d, dtype=dt), randn(b, skv, hkv, d, dtype=dt),
                 randn(b, skv, hkv, d, dtype=dt)) for _ in range(copies(nb))]
        q, k, v = sets[0]
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        lerr = max_err(lse, ref_lse)
        ok = within(out, ref, atol, rtol) and lerr <= lse_tol
        if sq > skv:   # rows before the diagonal see no key
            dead = sq - skv
            ok = ok and bool((out[:, :dead] == 0).all().item()) and bool(
                (lse[:, :, :dead] == -1e30).all().item())
        kfns = [lambda t=t: flash_attention(*t, causal=True) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: flash_attention(*t, causal=True) for t in sets],
                budget_ms=100.0)
        if sq == skv:
            lib_ms = time_ms(torch, [
                lambda t=t: TF.scaled_dot_product_attention(
                    t[0].transpose(1, 2), t[1].transpose(1, 2),
                    t[2].transpose(1, 2), is_causal=True, enable_gqa=True)
                for t in sets])
        else:
            qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
            mask = torch.arange(skv, device=dev)[None, :] <= qi
            lib_ms = time_ms(torch, [
                lambda t=t: TF.scaled_dot_product_attention(
                    t[0].transpose(1, 2), t[1].transpose(1, 2),
                    t[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
                for t in sets])
        pairs = sum(max(0, min(skv, r + skv - sq + 1)) for r in range(sq))
        nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * esz \
            + 4 * b * hq * sq
        ops = 4 * d * hq * b * pairs
        bms, by = bound(nbytes, ops, BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record("flash_attention_fwd",
               f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} causal "
               f"{str(dt)[6:]}",
               max(err, lerr), f"out atol {atol} + rtol {rtol}, lse "
               f"{lse_tol}", ok, kfns, plain_ms, lib_ms, bms, by, main)
        del sets, q, k, v, out, lse, ref, ref_lse

    # ---- K3 RMSNorm: decode rows and a prefill wave's rows (bf16, hidden
    # 4096), then the tiny model's float32 rows (hidden 64) ------------------
    for dt, rows, hidden, main in ((bf16, 8, 4096, False),
                                   (bf16, 4 * 2048, 4096, True),
                                   (f32, 16, 64, False)):
        atol, rtol = tols(dt)
        esz = 2 if dt == bf16 else 4
        w = 1.0 + 0.1 * randn(hidden, dtype=dt)
        sets = [(randn(rows, hidden, dtype=dt),)
                for _ in range(copies(rows * hidden * 4))]
        x = sets[0][0]
        got = rms_norm(x, w, 1e-5)
        want = rms_norm_reference(x, w, 1e-5)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        kfns = [lambda t=t: rms_norm(t[0], w, 1e-5) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [lambda t=t: rms_norm(t[0], w, 1e-5)
                                       for t in sets])
        lib_ms = time_ms(torch, [
            lambda t=t: TF.rms_norm(t[0], (hidden,), w, 1e-5)
            for t in sets])
        nbytes = (2 * rows * hidden + hidden) * esz
        bms, by = bound(nbytes, 4 * rows * hidden, F32_FLOPS)
        record("rms_norm", f"rows={rows} D={hidden} {str(dt)[6:]}", err,
               f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms, lib_ms, bms,
               by, main)
        del sets, x, got, want, w

    emit({"phase": "kernels_summary",
          "kernels": [dict(name=n, **r) for n, r in results.items()]})
    return results


# -- phase 3 ------------------------------------------------------------------------

def phase_model(torch):
    from paddle_tpu_torch.models import (LlamaForCausalLM, init_kv_cache,
                                         llama3_8b_config, tiny_llama_config)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.serving import ServingEngine
    import numpy as np

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = llama3_8b_config()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    rng = np.random.RandomState(0)
    b, plen, max_len = 2, 64, 256
    prompt = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (b, plen)).astype(np.int32)).to(dev)
    forced = rng.randint(0, cfg.vocab_size, (4, b)).astype(np.int32)

    def teacher_forced(m):
        cache = init_kv_cache(m.config, b, max_len, device=dev)
        outs = []
        with torch.no_grad():
            logits, cache = m.decode_step(prompt, cache, 0)
            outs.append(logits.float())
            pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
            for t in range(forced.shape[0]):
                tok = torch.from_numpy(forced[t][:, None]).to(dev)
                logits, cache = m.decode_step(tok, cache, pos)
                outs.append(logits.float())
                pos = pos + 1
        torch.cuda.synchronize()
        return outs

    got = teacher_forced(model)
    with reference_mode():
        want = teacher_forced(model)
    # the float32 truth: the same weights in float32 through the plain path
    model32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                               device=dev)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    with reference_mode():
        truth = teacher_forced(model32)
    del model32
    torch.cuda.empty_cache()

    def worst(xs, ys):
        return max(max_err(x, y) for x, y in zip(xs, ys))

    diff, err_kernel, err_plain = (worst(got, want), worst(got, truth),
                                   worst(want, truth))
    scale = max(float(w.abs().max().item()) for w in truth)
    finite = all(bool(torch.isfinite(g).all().item()) for g in got)
    # tolerance: both bf16 paths round the same products and differ only
    # in the order of float32 sums inside attention and RMSNorm (and K2's
    # bf16 P in P.V), so the kernel path must sit as close to the float32
    # model as the plain path does: within 1.2x of the plain path's own
    # distance
    tol = 1.2 * err_plain
    emit({"phase": "model", "config": "llama3_8b", "params": n_params,
          "init_s": round(init_s, 3), "prefill_tokens": plen, "batch": b,
          "decode_steps": int(forced.shape[0]),
          "max_logit_diff_kernel_vs_plain": diff,
          "max_logit_err_kernel_vs_f32": err_kernel,
          "max_logit_err_plain_vs_f32": err_plain,
          "max_abs_logit": scale, "tol_kernel_vs_f32": tol,
          "finite": finite})
    check(finite, "model logits are not finite")
    check(err_kernel <= tol,
          f"kernel path is {err_kernel} from the float32 model, the plain "
          f"path {err_plain} (tolerance {tol})")

    # tiny float32 engine: kernels on the card vs plain versions on the CPU
    tiny = tiny_llama_config()
    prompts = [rng.randint(0, tiny.vocab_size, n).astype(np.int32)
               for n in (5, 9, 17, 3, 30, 11)]

    tiny_cpu = LlamaForCausalLM(tiny, device="cpu", seed=1)
    tiny_card = copy.deepcopy(tiny_cpu).to(dev)   # the same weights

    def serve(m, device):
        eng = ServingEngine(m, num_slots=2, max_length=64, device=device)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        out = dict(eng.drain())
        return [out[r] for r in rids]

    on_card, on_cpu = serve(tiny_card, "cuda"), serve(tiny_cpu, "cpu")
    emit({"phase": "model_tiny_f32", "requests": len(prompts),
          "identical": on_card == on_cpu})
    check(on_card == on_cpu,
          f"tiny f32 engine differs card vs cpu: {on_card} vs {on_cpu}")
    return model


# -- phase 4 ------------------------------------------------------------------------

def serving_prompts(vocab: int):
    import numpy as np
    rng = np.random.RandomState(1)
    lengths = (5, 1500, 37, 700, 12, 260, 1023, 90, 8, 1200, 400, 64)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def phase_serving(torch, model, kernels):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, num_slots=8, max_length=4096,
                        prefill_batch=4, device="cuda")
    prompts = serving_prompts(model.config.vocab_size)
    new_tokens = 32
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    out = dict(eng.drain())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    m = eng.metrics()
    ntok = sum(len(out[r]) for r in rids)
    emit({"phase": "serving", "requests": len(rids),
          "prompt_lengths": [int(p.size) for p in prompts],
          "new_tokens": new_tokens, "tokens": ntok, "wall_s": round(wall, 4),
          "tok_per_s": round(ntok / wall, 2),
          "decode_step_ms": m["decode_step_ms"], "ttft_ms": m["ttft_ms"],
          "tpot_ms": m["tpot_ms"], "prefill_wave_ms": m["prefill_wave_ms"],
          "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"], "launches": launches})
    vocab = model.config.vocab_size
    for r in rids:
        check(len(out[r]) == new_tokens,
              f"request {r} returned {len(out[r])} tokens")
        check(all(0 <= t < vocab for t in out[r]),
              f"request {r} returned a token outside the vocabulary")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the serving path")
    for name, row in kernels.items():
        row["launches"] = launches[name]
    return eng


def device_us(prof, n: int):
    """Device time per call (us) by kernel name from a profiler window of
    ``n`` calls."""
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.key and not ev.key.startswith(("aten::", "cuda")):
            out[ev.key[:60]] = round(t / n, 3)
    return out


def phase_profile(torch, model):
    """K1's device time against its split length at the phase-2 decode
    shape, then torch.profiler over a few decode ticks of 8 busy slots."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import decode_attention_cuda
    from paddle_tpu_torch.serving import ServingEngine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pos = torch.tensor([0, 4095, 17, 1000, 2047, 3000, 511, 128],
                       dtype=torch.int32, device=dev)
    q, kc, vc = (torch.randn(shape, generator=gen, device=dev,
                             dtype=torch.bfloat16)
                 for shape in ((8, 1, 32, 128), (8, 4096, 8, 128),
                               (8, 4096, 8, 128)))
    sweep = {}
    default_split = flags.flag("decode_attention_block_kv")
    for split in (64, 128, 256, 512, 1024, 4096):
        flags.set_flags({"decode_attention_block_kv": split})
        for _ in range(3):
            decode_attention_cuda(q, kc, vc, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                decode_attention_cuda(q, kc, vc, pos)
            torch.cuda.synchronize()
        sweep[split] = device_us(prof, 20)
    flags.set_flags({"decode_attention_block_kv": default_split})
    emit({"phase": "profile_k1_split", "shape": "B=8 s=1 L=4096 Hq=32 "
          "Hkv=8 D=128 pos=[0, 4095, 17, 1000, 2047, 3000, 511, 128]",
          "device_us_by_split_len": sweep})
    del q, kc, vc

    eng = ServingEngine(model, num_slots=8, max_length=4096,
                        prefill_batch=4, device="cuda")
    for p in serving_prompts(model.config.vocab_size)[:8]:
        eng.submit(p, max_new_tokens=16)
    for _ in range(4):          # admission waves + warm decode ticks
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    total = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.key and not ev.key.startswith(("aten::", "cuda")):
            rows.append((t, ev.key, ev.count))
            total += t
    rows.sort(reverse=True)
    emit({"phase": "profile", "ticks": 5, "wall_ms": round(wall_ms, 3),
          "device_kernel_ms": round(total / 1e3, 3),
          "device_busy_share": round(total / 1e3 / wall_ms, 4),
          "top": [{"kernel": k[:90], "ms": round(t / 1e3, 3), "calls": c}
                  for t, k, c in rows[:15]]})
    eng.drain()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window after phase 4")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops.cuda import _build

    t_start = time.perf_counter()
    phase_card(torch, _build)
    kernels = phase_kernels(torch)
    model = phase_model(torch)
    phase_serving(torch, model, kernels)
    if args.profile:
        phase_profile(torch, model)
    emit({"kernels": [dict(name=n, **KERNEL_INFO[n], **r)
                      for n, r in kernels.items()]})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            3)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
