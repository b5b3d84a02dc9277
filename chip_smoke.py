#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds every kernel of the serving and training paths from the sources
in the checkout, holds each against its plain PyTorch version, runs the
model at the full Llama-3-8B width, serves requests through the engine
and trains a 4-layer cut of the model.  Every phase prints one JSON line;
any failed check raises, so the script exits non-zero.  Phases:

  1. card      — ``nvidia-smi`` name and power limit, torch/CUDA versions,
                 the kernels' build time (one ``nvcc`` per source, all at
                 once) and ptxas's registers / spill bytes per library;
                 fails if ptxas reports that it serialised the
                 ``wgmma.mma_async`` instructions of any kernel (named);
  2. kernels   — K1 flash-decode, K2 flash-attention forward and K3
                 RMSNorm at the serving path's Llama-3-8B shapes (bf16),
                 then K1-paged (decode tick) and K2-paged (suffix prefill)
                 on pools built so a kernel cannot pass by accident
                 (physical blocks shuffled, rows sharing their first
                 blocks, null-filled dead tails), then the int8 builds:
                 K1-int8 over a contiguous int8 cache with 128-token scale
                 granules, K1-paged-int8 and K2-paged-int8 over int8 pools
                 with per-block scales, and K4, the weight-only int8 GEMM,
                 at every Llama-3-8B projection shape (8 rows), at the row
                 counts a prefill wave sends it (16, 64, 128 rows of
                 gate/up) and at 256 rows (its limit); K2 with
                 packed-document segment ids and the flash
                 backward K5 (dq) / K6 (dk, dv) at the training
                 micro-batch's shape (B=2, S=2048, 3-8 documents a row;
                 bf16 gradients held by their relative L2 error per
                 tensor); then the flash kernels' contract branches no
                 training step takes: K2, K5 and K6 at causal=False, in
                 the ring-hop form (separate kv_segment_ids, Sq 256 vs
                 Skv 1024, queries whose id matches no key) and packed at
                 S = 77 (ids at unaligned offsets), every row checking
                 the dead-row convention (out 0, lse -1e30, zero
                 gradient) and K5 / K6 giving the same bits twice; each
                 also at the tiny model's float32 shapes:
                 max error against the plain version beside the stated
                 tolerance, kernel / host / plain / library / bound times
                 in ms;
  3. model     — ``LlamaForCausalLM(llama3_8b_config())``, 32 layers,
                 random weights from a seeded ``torch.Generator``:
                 teacher-forced ``decode_step`` (prefill + 4 decode steps)
                 with the kernels, under ``reference_mode()``, and on a
                 float32 copy of the weights (the truth); the kernel path's
                 logit error against the truth must be within the stated
                 tolerance of the plain path's; the same gate for a paged
                 session (prefix written into scattered blocks, a suffix
                 prefill at per-row pos > 0, 4 decode steps through the
                 block table), and for that paged session served by the
                 int8 model (``quantize_for_decode``: int8 weights) over an
                 int8 pool, held against the same float32 truth
                 (``model_int8``); then a tiny float32 engine on the card
                 (kernels) against the same engine on the CPU (plain
                 versions): greedy tokens must be identical, and the
                 tiny PAGED engine on the card must match both the paged
                 engine on the CPU and the contiguous engine on the card;
                 the tiny int8 engines (int8 KV and int8 weights,
                 contiguous and paged) must match themselves on the CPU;
  4. serving   — ``ServingEngine(num_slots=8, max_length=4096,
                 prefill_batch=4)`` on 12 requests of 5..1500 prompt
                 tokens, 32 new tokens each; every launch counter is reset
                 just before and read just after; tok/s, step ms, TTFT;
  4b. serving_paged — the same engine with ``paged=True, block_len=128,
                 num_blocks=52`` on 16 requests: 8 open with one shared
                 1536-token system prompt, 8 are unique, interleaved; the
                 pool is sized so blocks are evicted and admissions wait;
                 checks prefix hits, launches (K1-paged 32 a decode tick,
                 K2-paged 32 a wave, contiguous K1/K2 none, no plain
                 route); tok/s, step ms, TTFT, wave ms;
  4c. serving_int8 — phase 4b's engine, requests and pool with
                 ``kv_cache_dtype="int8", int8_weights=True``: the same
                 schedule as 4b (it depends on lengths and prompt tokens
                 only), K1-paged-int8 32 a decode tick, K2-paged-int8 32 a
                 wave, K4 at least 7 x 32 + 1 a decode tick, no bf16
                 attention kernel, no plain route; tok/s, step ms, TTFT,
                 pool bytes, the model's ``hbm_bytes()``;
  4d. serving_int8_contiguous — phase 4's engine and requests with the
                 same two options: K1-int8 32 a decode tick, K2 32 a wave
                 (the wave prefill attends its fresh K/V), K4 as in 4c;
  5. training  — after the serving models are freed: Llama-3-8B width cut
                 to 4 layers (bf16, ``recompute=True``), packed 4 x 2048
                 batches (3-8 documents a row, restarting positions),
                 ``build_train_step(grad_accum_steps=2)`` with AdamW
                 (lr 3e-4 after a 2-step linear warmup, beta2 0.95, eps
                 1e-5, weight decay 0.1, global-norm clip 1.0); gates:
                 (a) step-1 gradients of one micro-batch, kernel path
                 within 1.2x the plain path's relative L2 error against a
                 float32 copy, summed over every tensor and tensor by
                 tensor; (b) 8 steps, every loss finite, the last
                 below the first; (c) launches a step K2 = 4 x layers,
                 K5 = K6 = 2 x layers, no plain route; (d) the tiny float32
                 model trained 4 steps on the card and on the CPU from the
                 same weights (packed and not): losses and parameters
                 within the stated tolerance.  Step ms, tokens/s, model
                 FLOPs over step time against 989 TFLOP/s, peak memory.

Then the ``{"kernels": [...]}`` line (launches of K1, K2, K3 from phase 4,
of K1-paged and K2-paged from phase 4b, of K1-paged-int8, K2-paged-int8
and K4 from phase 4c, of K1-int8 from phase 4d, of K5 and K6 from phase
5; error and times from phase 2) and, last, ``{"ok": true, "device":
{...}}``.

``--profile`` adds a torch.profiler window over a few decode ticks of the
contiguous, paged and int8 paged engines and over one phase-5 train step
(kernel time by name and class, the optimizer's device time, device busy
share) for PERF.md.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
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
    "decode_attention_paged": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "flash_attention_fwd_paged": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "decode_attention_int8": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "decode_attention_paged_int8": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "flash_attention_fwd_paged_int8": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "int8_matmul": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "paddle_tpu/ops/pallas/int8_matmul.py:38"},
    "flash_attention_bwd_dq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:252"},
    "flash_attention_bwd_dkv": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:299"},
}
# the paged kernels have no one-call PyTorch counterpart: their library
# yardstick is SDPA over a contiguous copy gathered beforehand (untimed)
PAGED_LIBRARY_NOTE = ("F.scaled_dot_product_attention over a pre-gathered "
                      "contiguous copy; the gather is not timed")
INT8_LIBRARY_NOTE = ("F.scaled_dot_product_attention over a dequantized "
                     "(and, paged, pre-gathered) bf16/f32 copy; the dequant "
                     "and gather are not timed")
MATMUL_LIBRARY_NOTE = ("torch.matmul against the bf16/f32 weight the int8 "
                       "one replaces")
BWD_LIBRARY_NOTE = ("the backward of F.scaled_dot_product_attention "
                    "(enable_gqa; is_causal, or on packed rows the dense "
                    "mask below), timed alone: the forward runs once a "
                    "input set, untimed, then torch.autograd.grad("
                    "retain_graph=True) is timed; it computes dq, dk and dv "
                    "in one call: compare with K5 + K6")
SEGMENTED_LIBRARY_NOTE = ("F.scaled_dot_product_attention (enable_gqa) with "
                          "a dense (B, 1, Sq, Skv) bool mask, causal and "
                          "same document, built outside the timed call: it "
                          "computes every pair the mask hides")
# bf16 gradients are held by their relative L2 error per tensor: the
# kernels round P and dS to bf16 (unit roundoff 2^-9 ~ 2e-3) before the
# products and the outputs to bf16 once (2^-9 again), against the plain
# version's float32 math; 1e-2 leaves a 2.5x margin over the ~4e-3 those
# two roundings give, and a wrong mask or a missing tile is O(1)
BWD_REL_TOL_BF16 = 1e-2
# phase 5: Llama-3-8B width cut to 4 layers (training state of the full
# 32-layer model, ~16 bytes a parameter, does not fit one 80 GB card)
TRAIN_LAYERS = 4
TRAIN_ROWS, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 2048, 2, 8
TRAIN_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# gate (a) per tensor: a floor under 1.2x the plain path's relative L2
# error, for tensors whose plain error is near 0; a wrong kernel is O(1)
GRAD_TENSOR_FLOOR = 1e-3
LAYERS_8B = 32
# the kernels of the default (contiguous) engine's path, phase 4
CONTIGUOUS_PATH = ("decode_attention", "flash_attention_fwd", "rms_norm")
PAGED_POOL_BLOCKS = 52          # phase 4b: evictions + waiting admissions
# phase 4b's schedule (lengths and prompt tokens only), which phase 4c repeats
PAGED_SCHEDULE = {"prefill_waves": 5, "decode_ticks": 93,
                  "prefill_tokens_computed": 8680,
                  "prefill_tokens_total": 19432, "evictions": 3,
                  "admission_blocked": 32}
# K4 launches of one decode tick: q, k, v, o, gate, up, down a layer + lm_head
K4_PER_TICK = 7 * LAYERS_8B + 1
TINY_MIN_ELEMS = 2048           # every tiny projection, not the RoPE tables


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


def _device_time(ev) -> float:
    t = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if t is None else t


def kernel_rows(prof):
    """[(device us, kernel name, calls)] of the kernels of a profiler
    window, longest first.  Host-side ranges (ops, autograd nodes, user
    annotations) are left out: their device time is their kernels' again."""
    from torch.autograd import DeviceType
    rows = [(_device_time(ev), ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.key
            and not getattr(ev, "is_user_annotation", False)
            and _device_time(ev)]
    return sorted(rows, reverse=True)


def device_ms(torch, fns, n: int = 40) -> float:
    """Device time of one call by the profiler (CUPTI): the sum of the
    kernels' device times over ``n`` calls, over ``n``; 0.0 if three
    profiler windows in a row recorded no kernel."""
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        total = sum(t for t, _, _ in kernel_rows(prof))
        if total > 0:
            return total / n / 1e3
    return 0.0


def top_kernel(torch, fn) -> str:
    """Name of the longest kernel of one call of ``fn`` (which backend a
    library call took), by the profiler; "not measured" if it saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    return rows[0][1][:90] if rows else "not measured"


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

def ptxas_functions(log: str):
    """Registers and spill-store bytes of each entry function in ptxas's
    ``-v`` report (mangled names; ``Lb1E`` marks a paged build)."""
    out, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = {"registers": int(m.group(1)), "spill_stores": spill}
            fn = None
    return out


def serialized_wgmma(log: str):
    """ptxas's reports that it serialised a kernel's ``wgmma.mma_async``
    instructions (C7509-C7515: a conditional issue, a register touched
    between issue and wait, a call inside the pipeline, too few registers),
    as [(function, reason)]; such a kernel runs its products
    one after another, 30-40 % slower, and builds without an error."""
    out = []
    for line in log.splitlines():
        if "wgmma" not in line or "serializ" not in line:
            continue
        m = re.search(r"(?:in|for) the function '([^']+)'", line)
        reason = re.search(
            r"serialized (due to .*?)(?: (?:in|for) the function|$)", line)
        out.append((m.group(1) if m else "unnamed",
                    reason.group(1).strip() if reason else line.strip()))
    return out


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
    ptxas, serialized = {}, {}
    for name, log in pt_build.build_log.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        ptxas[name] = {"max_registers": max(regs, default=None),
                       "spill_store_bytes": sum(spills),
                       "functions": ptxas_functions(log)}
        if serialized_wgmma(log):
            serialized[name] = serialized_wgmma(log)
    emit({"phase": "card", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc_build_s": round(build_s, 3),
          "ptxas_logs": sorted(pt_build.build_log),
          "wgmma_serialized": serialized, "ptxas": ptxas})
    check(not serialized, f"ptxas serialised wgmma in {serialized}")
    return card


# -- phase 2 ------------------------------------------------------------------------

def paged_layout(pos_list, s, bl, mb, share, seed):
    """Block tables for rows reading keys [0, min(pos_b + s, mb * bl)):
    physical blocks drawn from a shuffled pool (8 spare blocks no row
    references), each ``(r0, r1, n)`` of ``share`` making row r1 reuse row
    r0's first n blocks, the dead tail null (block 0).  Returns (int32
    tables (B, mb), pool size in blocks, distinct live keys)."""
    import numpy as np
    need = [min(mb, -(-(p + s) // bl)) for p in pos_list]
    rng = np.random.RandomState(seed)
    n_blocks = sum(need) + 9
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((len(pos_list), mb), np.int32)
    for r, n in enumerate(need):
        for j in range(n):
            tables[r, j] = free.pop()
    for r0, r1, n in share:
        tables[r1, :min(n, need[r0], need[r1])] = \
            tables[r0, :min(n, need[r0], need[r1])]
    live = set()
    for r, p in enumerate(pos_list):
        for j in range(min(p + s, mb * bl)):
            live.add((int(tables[r, j // bl]), j % bl))
    return tables, n_blocks, len(live)


def packed_segments(rows: int, seq: int, seed: int, lo: int = 3,
                    hi: int = 8):
    """(rows, seq) int32 packed-document ids: lo..hi documents a row, cut
    at seeded positions."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = np.zeros((rows, seq), np.int32)
    for r in range(rows):
        n = min(rng.randint(lo, hi + 1), seq)
        for c in sorted(rng.choice(np.arange(1, seq), n - 1, replace=False)):
            out[r, c:] += 1
    return out


def causal_pairs(seg, b: int, s: int) -> int:
    """Visible (query, key) pairs of causal self-attention over b rows of s
    tokens, within each packed document when ``seg`` (b, s) is given."""
    if seg is None:
        return b * s * (s + 1) // 2
    lens = torch_counts(seg)
    return int(sum(n * (n + 1) // 2 for n in lens))


def torch_counts(seg):
    """Lengths of every document of every row of a (b, s) id tensor."""
    out = []
    for row in seg.cpu().tolist():
        run = 1
        for a, c in zip(row, row[1:]):
            if a == c:
                run += 1
            else:
                out.append(run)
                run = 1
        out.append(run)
    return out


def visible_pairs(torch, sq, skv, causal, seg_q=None, seg_kv=None,
                  device=None):
    """(B or 1, Sq, Skv) bool: the (query, key) pairs attention sees —
    causal bottom-right (query i sees keys j <= i + Skv - Sq) and, with
    segment ids, the same document.  A row with none is a dead row: out 0,
    lse -1e30, zero gradient."""
    keep = torch.ones(1, sq, skv, dtype=torch.bool, device=device)
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + (skv - sq)
        keep = keep & (torch.arange(skv, device=device)[None, :] <= qi)
    if seg_q is not None:
        keep = keep & (seg_q[:, :, None] == seg_kv[:, None, :])
    return keep


def dead_rows_ok(torch, keep, b, out=None, lse=None, grad=None) -> bool:
    """The dead-row convention on the rows of ``keep`` with no visible key:
    out exactly 0, lse exactly -1e30, the gradient exactly 0."""
    dead = ~keep.any(-1).expand(b, keep.shape[1])          # (B, Sq)
    ok = True
    if out is not None:
        ok = ok and bool((out[dead] == 0).all().item())
    if lse is not None:
        ok = ok and bool((lse.transpose(1, 2)[dead] == -1e30).all().item())
    if grad is not None:
        ok = ok and bool((grad[dead] == 0).all().item())
    return ok


def phase_kernels(torch):
    from paddle_tpu_torch.ops import (cached_decode_attention,
                                      cached_decode_attention_reference,
                                      flash_attention,
                                      flash_attention_reference,
                                      int8_matmul_cuda,
                                      int8_matmul_reference, rms_norm,
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
               main, note=None, extra=None):
        ms, hms = time_ms(torch, kfns), host_ms(torch, kfns)
        dms = device_ms(torch, kfns)
        timed_by = "events"
        if dms > 0 and ms > 1.1 * dms:
            # the events timed the host's enqueue (a call that enqueues
            # slower than the device runs it): take the kernels' own
            # device time from the profiler
            ms, timed_by = dms, "profiler"
        row = {"phase": "kernels", "kernel": name, "shape": shape,
               "max_err": err, "tol": tol, "ok": ok, "kernel_ms": ms,
               "timed_by": timed_by, "device_ms": dms, "host_ms": hms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
               "bound_by": by}
        if note:
            row["library_note"] = note
        row.update(extra or {})
        emit(row)
        check(ok, f"{name} {shape}: max error {err} beyond {tol}")
        agg = results.setdefault(name, {"max_abs_err": 0.0})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        if main:
            agg.update(shape=shape, ms=ms, timed_by=timed_by,
                       plain_ms=plain_ms,
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
    # head_dim 128), then the tiny model's float32 build (head_dim 16);
    # causal (the serving and training paths), then causal=False, the
    # reference's default (full-attention models, ring hops) -------------
    for dt, hq, hkv, d, b, sq, skv, causal, main in (
            (bf16, 32, 8, 128, 4, 8, 8, True, False),
            (bf16, 32, 8, 128, 4, 100, 100, True, False),
            (bf16, 32, 8, 128, 4, 512, 512, True, False),
            (bf16, 32, 8, 128, 4, 2048, 2048, True, True),
            (bf16, 32, 8, 128, 4, 100, 612, True, False),
            (bf16, 32, 8, 128, 2, 128, 64, True, False),
            (bf16, 32, 8, 128, 2, 512, 512, False, False),
            (bf16, 32, 8, 128, 2, 100, 612, False, False),
            (f32, 4, 2, 16, 2, 32, 32, True, False),
            (f32, 4, 2, 16, 2, 70, 100, True, False),
            (f32, 4, 2, 16, 2, 24, 8, True, False),
            (f32, 4, 2, 16, 2, 70, 100, False, False)):
        atol, rtol = tols(dt)
        lse_tol = 1e-3 if dt == bf16 else 1e-5
        esz = 2 if dt == bf16 else 4
        nb = b * (sq * hq + 2 * skv * hkv) * d * esz
        sets = [(randn(b, sq, hq, d, dtype=dt), randn(b, skv, hkv, d, dtype=dt),
                 randn(b, skv, hkv, d, dtype=dt)) for _ in range(copies(nb))]
        q, k, v = sets[0]
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        lerr = max_err(lse, ref_lse)
        keep = visible_pairs(torch, sq, skv, causal, device=dev)
        ok = (within(out, ref, atol, rtol) and lerr <= lse_tol
              and dead_rows_ok(torch, keep, b, out, lse))
        kfns = [lambda t=t: flash_attention(*t, causal=causal) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: flash_attention(*t, causal=causal) for t in sets],
                budget_ms=100.0)
        mask = None if (sq == skv or not causal) else keep[:, None]
        lib_ms = time_ms(torch, [
            lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            for t in sets])
        pairs = int(keep.sum().item())
        nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * esz \
            + 4 * b * hq * sq
        ops = 4 * d * hq * b * pairs
        bms, by = bound(nbytes, ops, BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record("flash_attention_fwd",
               f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} "
               f"{'causal' if causal else 'causal=False'} {str(dt)[6:]}",
               max(err, lerr), f"out atol {atol} + rtol {rtol}, lse "
               f"{lse_tol}, dead rows out 0 and lse -1e30", ok, kfns,
               plain_ms, lib_ms, bms, by, main)
        del sets, q, k, v, out, lse, ref, ref_lse

    # ---- K2 with segment ids, K5 / K6 (the flash backward): the training
    # micro-batch's shape (B=2, S=2048, Hq/Hkv 32/8, D=128, bf16, causal,
    # rows packed with 3-8 documents of seeded lengths), ragged bf16
    # shapes, then the tiny model's float32 builds; segmented and not.
    # Then the contract branches no training step takes: causal=False, and
    # the ring-hop form -- separate kv_segment_ids with Sq != Skv, where
    # some query ids match no key (dead rows).  The backward rows are fed
    # K2's own out and lse; their plain version is
    # flash_attention_bwd_reference (dq, dk, dv together) ------------------
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_reference,
                                      flash_attention_fwd_cuda)

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    # segments: None; "packed" (self-attention, 3-8 documents a row); "ring"
    # (3-6 query documents whose first two ids are the last two of the
    # row's 3-8 key documents: the other queries see no key)
    for dt, b, sq, skv, hq, hkv, d, causal, segments, main in (
            (bf16, 2, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 128, True, "packed", True),
            (bf16, 2, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 128, True, None, False),
            (bf16, 2, 200, 200, 32, 8, 128, True, "packed", False),
            (bf16, 2, 77, 77, 32, 8, 128, True, "packed", False),
            (bf16, 2, 512, 512, 32, 8, 128, False, None, False),
            (bf16, 1, 256, 1024, 32, 8, 128, False, "ring", False),
            (bf16, 1, 256, 1024, 32, 8, 128, True, "ring", False),
            (f32, 2, 37, 37, 4, 2, 16, True, "packed", False),
            (f32, 2, 70, 70, 4, 2, 16, True, None, False),
            (f32, 2, 70, 70, 4, 2, 16, False, None, False),
            (f32, 1, 40, 100, 4, 2, 16, False, "ring", False)):
        esz = 2 if dt == bf16 else 4
        seg = kv_seg = None
        if segments == "packed":
            seg = torch.from_numpy(packed_segments(b, sq, seed=sq)).to(dev)
        elif segments == "ring":
            ids_kv = packed_segments(b, skv, seed=skv)
            ids_q = (packed_segments(b, sq, seed=sq, lo=3, hi=6)
                     + ids_kv.max(1, keepdims=True) - 1)
            seg = torch.from_numpy(ids_q).to(dev)
            kv_seg = torch.from_numpy(ids_kv).to(dev)
        keep = visible_pairs(torch, sq, skv, causal, seg,
                             seg if kv_seg is None else kv_seg, dev)
        pairs = int(keep.expand(b, sq, skv).sum().item())
        n_dead = int((~keep.any(-1)).expand(b, sq).sum().item())
        nb = b * (2 * sq * hq + 2 * skv * hkv) * d * esz
        kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
        sets = []
        for _ in range(copies(nb)):
            q, k, v, do = (randn(b, sq, hq, d, dtype=dt),
                           randn(b, skv, hkv, d, dtype=dt),
                           randn(b, skv, hkv, d, dtype=dt),
                           randn(b, sq, hq, d, dtype=dt))
            dlse = randn(b, hq, sq, dtype=f32)
            out, lse = flash_attention_fwd_cuda(q, k, v, **kw)
            delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
                     - dlse).contiguous()
            sets.append((q, k, v, do, dlse, out, lse, delta))
        shape = (f"S={sq}" if sq == skv and segments != "ring"
                 else f"Sq={sq} Skv={skv}")
        tag = (f"B={b} {shape} Hq={hq} Hkv={hkv} D={d} "
               f"{'causal' if causal else 'causal=False'} "
               f"{'packed ' if segments == 'packed' else ''}"
               f"{'ring-hop kv_segment_ids ' if segments == 'ring' else ''}"
               f"{str(dt)[6:]}")
        seg_extra = {"segmented": seg is not None, "visible_pairs": pairs,
                     "dead_rows": n_dead}
        # the library yardstick's mask where the rule is not plain causal:
        # dense (B or 1, 1, Sq, Skv), made here so no timed call builds it
        lib_mask = (None if seg is None and (sq == skv or not causal)
                    else keep[:, None])
        q, k, v, do, dlse, out, lse, delta = sets[0]
        if segments == "ring":
            check(0 < n_dead < b * sq, f"{tag}: {n_dead} of {b * sq} "
                                       f"queries see no key")

        # K2 with segment ids (forward), against the plain path
        if seg is not None:
            with reference_mode():
                ref, ref_lse = flash_attention(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            atol, rtol = tols(dt)
            lse_tol = 1e-3 if dt == bf16 else 1e-5
            err, lerr = max_err(out, ref), max_err(lse, ref_lse)
            ok = (within(out, ref, atol, rtol) and lerr <= lse_tol
                  and dead_rows_ok(torch, keep, b, out, lse))
            kfns = [lambda t=t: flash_attention_fwd_cuda(t[0], t[1], t[2],
                                                         **kw) for t in sets]
            with reference_mode():
                plain_ms = time_ms(torch, [
                    lambda t=t: flash_attention(t[0], t[1], t[2], **kw)
                    for t in sets], budget_ms=100.0)
            lfns = [lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=lib_mask, enable_gqa=True)
                for t in sets]
            lib_ms = time_ms(torch, lfns)
            seg_extra["library_kernel"] = top_kernel(torch, lfns[0])
            nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * esz \
                + 4 * b * hq * sq + 4 * b * (sq + (skv if kv_seg is not None
                                                   else 0))
            bms, by = bound(nbytes, 4 * d * hq * pairs,
                            BF16_FLOPS if dt == bf16 else F32_FLOPS)
            record("flash_attention_fwd", tag, max(err, lerr),
                   f"out atol {atol} + rtol {rtol}, lse {lse_tol}, dead rows "
                   f"out 0 and lse -1e30", ok, kfns, plain_ms, lib_ms, bms,
                   by, False, note=SEGMENTED_LIBRARY_NOTE, extra=seg_extra)
            del ref, ref_lse

        # K5 / K6 against the plain backward on the same out / lse, and
        # against themselves: no atomics, so a second launch gives the same
        # bits
        dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        same = {"flash_attention_bwd_dq": torch.equal(
                    dq, flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                    **kw)),
                "flash_attention_bwd_dkv": all(map(torch.equal, (dk, dv), (
                    flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 **kw))))}
        rq, rk, rv = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                   dlse, **kw)
        torch.cuda.synchronize()
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: flash_attention_bwd_reference(
                    t[0], t[1], t[2], t[5], t[6], t[3], t[4], **kw)
                for t in sets], budget_ms=100.0)
        # SDPA's backward alone: one untimed forward a set, then the
        # backward is timed on the retained graph
        graphs = []
        for t in sets:
            leaves = tuple(x.transpose(1, 2).detach().clone()
                           .requires_grad_(True) for x in t[:3])
            o = TF.scaled_dot_product_attention(
                *leaves, attn_mask=lib_mask,
                is_causal=causal and lib_mask is None, enable_gqa=True)
            graphs.append((o, leaves, t[3].transpose(1, 2)))
        lfns = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2],
                                                retain_graph=True)
                for g in graphs]
        lib_ms = time_ms(torch, lfns)
        bwd_extra = dict(seg_extra, library_kernel=top_kernel(torch, lfns[0]))
        del graphs, lfns
        io = 4 * b * hq * sq * 2 + (0 if seg is None else 4 * b * sq) \
            + (0 if kv_seg is None else 4 * b * skv)
        # keys no query sees get zero dk and dv, as dead rows get zero dq
        dead_keys = (~keep.any(1)).expand(b, skv)
        for name, got, want, flops_per_pair, out_elems in (
                ("flash_attention_bwd_dq", (dq,), (rq,), 6, b * sq * hq * d),
                ("flash_attention_bwd_dkv", (dk, dv), (rk, rv), 8,
                 2 * b * skv * hkv * d)):
            err = max(max_err(g, w) for g, w in zip(got, want))
            rels = [rel_l2(g, w) for g, w in zip(got, want)]
            if dt == bf16:
                tol = f"relative L2 per tensor <= {BWD_REL_TOL_BF16}"
                ok = max(rels) <= BWD_REL_TOL_BF16
            else:
                atol, rtol = tols(dt)
                tol = f"atol {atol} + rtol {rtol}"
                ok = all(within(g, w, atol, rtol) for g, w in zip(got, want))
            ok = (ok and same[name]
                  and all(bool(torch.isfinite(g).all().item()) for g in got))
            if name.endswith("dq"):
                ok = ok and dead_rows_ok(torch, keep, b, grad=dq)
            else:
                ok = ok and all(bool((g[dead_keys] == 0).all().item())
                                for g in got)
            fn = (flash_attention_bwd_dq_cuda if name.endswith("dq")
                  else flash_attention_bwd_dkv_cuda)
            kfns = [lambda t=t, fn=fn: fn(t[0], t[1], t[2], t[3], t[6], t[7],
                                          **kw) for t in sets]
            nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d
                      + out_elems) * esz + io
            bms, by = bound(nbytes, flops_per_pair * d * hq * pairs,
                            BF16_FLOPS if dt == bf16 else F32_FLOPS)
            record(name, tag, err, tol + ", finite, dead rows (keys) 0, "
                   "the same bits twice", ok,
                   kfns, plain_ms, lib_ms, bms, by, main,
                   note=BWD_LIBRARY_NOTE + (
                       "; " + SEGMENTED_LIBRARY_NOTE if lib_mask is not None
                       else ""),
                   extra=dict(bwd_extra, rel_l2=rels,
                              deterministic=same[name],
                              plain_note="flash_attention_bwd_reference: dq, "
                                         "dk and dv together"))
            if (seg is None and causal and dt == bf16 and sq == TRAIN_SEQ):
                results[name]["library_ms_unsegmented"] = lib_ms
        del sets, q, k, v, do, dlse, out, lse, delta, dq, dk, dv, rq, rk, rv

    # ---- K1-paged / K2-paged: the paged engine's decode tick (s = 1) and
    # suffix prefill (s > 1) over a pool of block_len-token blocks, bf16 at
    # head_dim 128 (block_len 128, max_blocks 32: max_length 4096), then
    # the tiny model's float32 builds (head_dim 16).  Every pool has its
    # physical blocks shuffled, two row pairs sharing their first blocks
    # and null-filled dead tails; rows whose pos + s passes
    # max_blocks * block_len check the clamp.
    paged_rows = (
        # K1-paged: K1's phase-2 depths, so the two rows compare
        ("decode_attention_paged", bf16, 32, 8, 128, 8, 1, 128, 32,
         [0, 4095, 17, 1000, 2047, 3000, 511, 128], ((1, 4, 16), (5, 3, 8)),
         True),
        ("decode_attention_paged", bf16, 32, 8, 128, 2, 1, 16, 64,
         [33, 1000], ((0, 1, 2),), False),
        ("decode_attention_paged", f32, 4, 2, 16, 2, 1, 8, 8, [0, 40],
         ((0, 1, 1),), False),
        ("decode_attention_paged", f32, 4, 2, 16, 3, 1, 16, 4, [63, 5, 20],
         ((0, 2, 1),), False),
        # K2-paged: a 2048-token suffix bucket of 4 rows at adopted prefix
        # lengths 0..2048 (within max_length 4096)
        ("flash_attention_fwd_paged", bf16, 32, 8, 128, 4, 2048, 128, 32,
         [0, 128, 1024, 2048], ((2, 3, 8), (0, 1, 1)), True),
        ("flash_attention_fwd_paged", bf16, 32, 8, 128, 2, 8, 128, 32,
         [5, 700], ((0, 1, 1),), False),
        ("flash_attention_fwd_paged", bf16, 32, 8, 128, 3, 100, 128, 32,
         [0, 300, 4000], ((1, 2, 2),), False),
        ("flash_attention_fwd_paged", f32, 4, 2, 16, 2, 24, 8, 8, [5, 50],
         ((0, 1, 1),), False),
        ("flash_attention_fwd_paged", f32, 4, 2, 16, 3, 64, 16, 4,
         [0, 17, 40], ((1, 2, 1),), False))
    for (name, dt, hq, hkv, d, b, s, bl, mb, pos_list, share,
         main) in paged_rows:
        atol, rtol = tols(dt)
        esz = 2 if dt == bf16 else 4
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        tables, n_blocks, live_keys = paged_layout(pos_list, s, bl, mb,
                                                   share, seed=len(pos_list))
        tables = torch.from_numpy(tables).to(dev)
        nb = 2 * n_blocks * bl * hkv * d * esz
        sets = [(randn(b, s, hq, d, dtype=dt),
                 randn(n_blocks, bl, hkv, d, dtype=dt),
                 randn(n_blocks, bl, hkv, d, dtype=dt))
                for _ in range(copies(nb + b * s * hq * d * esz))]
        q, kp, vp = sets[0]
        got = cached_decode_attention(q, kp, vp, pos, block_tables=tables)
        want = cached_decode_attention_reference(q, kp, vp, pos,
                                                 block_tables=tables)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and bool(
            torch.isfinite(got).all().item())
        kfns = [lambda t=t: cached_decode_attention(*t, pos,
                                                    block_tables=tables)
                for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: cached_decode_attention(*t, pos,
                                                    block_tables=tables)
                for t in sets], budget_ms=100.0)
        L = mb * bl
        idx = tables.long()
        gathered = [(t[0], t[1][idx].reshape(b, L, hkv, d),
                     t[2][idx].reshape(b, L, hkv, d)) for t in sets]
        kj = torch.arange(L, device=dev)
        qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
        mask = (kj[None, None] <= qi[:, :, None])[:, None]      # B,1,s,L
        lib_ms = time_ms(torch, [
            lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
            for t in gathered])
        del gathered
        nbytes = (2 * b * s * hq * d * esz + live_keys * hkv * d * esz * 2
                  + 4 * b * (mb + 1))
        ops = sum(4 * d * hq * min(p + si + 1, L)
                  for p in pos_list for si in range(s))
        bms, by = bound(nbytes, ops, BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record(name,
               f"B={b} s={s} Hq={hq} Hkv={hkv} D={d} block_len={bl} "
               f"max_blocks={mb} pool={n_blocks} pos={pos_list} "
               f"shared={[list(x) for x in share]} {str(dt)[6:]}",
               err, f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms, lib_ms,
               bms, by, main, note=PAGED_LIBRARY_NOTE)
        del sets, q, kp, vp, got, want

    # ---- the int8 builds.  Payloads are random int8 in [-127, 127] with
    # random positive float32 scales; each plain version dequantizes them
    # in float32.  The library yardstick is SDPA over a dequantized copy
    # (and, paged, pre-gathered), made beforehand and not timed; the bound
    # counts the int8 payload and the scale rows a call must read.
    def int8_payload(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def int8_scales(*shape):
        return 0.002 + 0.02 * torch.rand(shape, generator=gen, device=dev)

    # K1-int8: the contiguous int8 cache at K1's phase-2 depths (128-token
    # granules), then the tiny model's one-granule float32 cache
    for dt, hq, hkv, d, b, s, L, n_gran, pos_list, main in (
            (bf16, 32, 8, 128, 8, 1, 4096, 32,
             [0, 4095, 17, 1000, 2047, 3000, 511, 128], True),
            (bf16, 32, 8, 128, 2, 4, 1024, 8, [0, 700], False),
            (f32, 4, 2, 16, 2, 1, 64, 1, [0, 40], False),
            (f32, 4, 2, 16, 2, 3, 64, 1, [5, 60], False)):
        atol, rtol = tols(dt)
        esz = 2 if dt == bf16 else 4
        gr = L // n_gran
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        sets = [(randn(b, s, hq, d, dtype=dt), int8_payload(b, L, hkv, d),
                 int8_payload(b, L, hkv, d), int8_scales(b, n_gran, hkv),
                 int8_scales(b, n_gran, hkv))
                for _ in range(copies(2 * b * L * hkv * d))]

        def run(t):
            return cached_decode_attention(t[0], t[1], t[2], pos,
                                           k_scale=t[3], v_scale=t[4])
        got = run(sets[0])
        with reference_mode():
            want = run(sets[0])
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        kfns = [lambda t=t: run(t) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, kfns, budget_ms=100.0)
        deq = [(t[0], (t[1].float().view(b, n_gran, gr, hkv, d)
                       * t[3][:, :, None, :, None]).view(b, L, hkv, d).to(dt),
                (t[2].float().view(b, n_gran, gr, hkv, d)
                 * t[4][:, :, None, :, None]).view(b, L, hkv, d).to(dt))
               for t in sets]
        kj = torch.arange(L, device=dev)
        qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
        mask = (kj[None, None] <= qi[:, :, None])[:, None]      # B,1,s,L
        lib_ms = time_ms(torch, [
            lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
            for t in deq])
        del deq
        live = [min(L, p + s) for p in pos_list]
        nbytes = (2 * b * s * hq * d * esz + sum(live) * hkv * d * 2
                  + sum(-(-n // gr) for n in live) * hkv * 4 * 2 + 4 * b)
        ops = sum(4 * d * hq * (p + si + 1)
                  for p in pos_list for si in range(s))
        bms, by = bound(nbytes, ops, BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record("decode_attention_int8",
               f"B={b} s={s} L={L} granule={gr} Hq={hq} Hkv={hkv} D={d} "
               f"pos={pos_list} int8 K/V, {str(dt)[6:]} q",
               err, f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms, lib_ms,
               bms, by, main, note=INT8_LIBRARY_NOTE)
        del sets, got, want

    # K1-paged-int8 / K2-paged-int8: the shapes of K1-paged / K2-paged
    # (same shuffled, shared, null-tailed tables) over int8 pools with
    # per-(block, kv head) scales
    for (name, dt, hq, hkv, d, b, s, bl, mb, pos_list, share,
         main) in paged_rows:
        name += "_int8"
        atol, rtol = tols(dt)
        esz = 2 if dt == bf16 else 4
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        tables, n_blocks, live_keys = paged_layout(pos_list, s, bl, mb,
                                                   share, seed=len(pos_list))
        live_blocks = len({int(tables[r, j // bl])
                           for r, p in enumerate(pos_list)
                           for j in range(0, min(p + s, mb * bl), bl)})
        tables = torch.from_numpy(tables).to(dev)
        sets = [(randn(b, s, hq, d, dtype=dt),
                 int8_payload(n_blocks, bl, hkv, d),
                 int8_payload(n_blocks, bl, hkv, d),
                 int8_scales(n_blocks, hkv), int8_scales(n_blocks, hkv))
                for _ in range(copies(2 * n_blocks * bl * hkv * d
                                      + b * s * hq * d * esz))]

        def run(t):
            return cached_decode_attention(t[0], t[1], t[2], pos,
                                           block_tables=tables,
                                           k_scale=t[3], v_scale=t[4])
        got = run(sets[0])
        with reference_mode():
            want = run(sets[0])
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and bool(
            torch.isfinite(got).all().item())
        kfns = [lambda t=t: run(t) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, kfns, budget_ms=100.0)
        L = mb * bl
        idx = tables.long()
        deq = [(t[0],
                (t[1][idx].float() * t[3][idx][:, :, None, :, None]).reshape(
                    b, L, hkv, d).to(dt),
                (t[2][idx].float() * t[4][idx][:, :, None, :, None]).reshape(
                    b, L, hkv, d).to(dt)) for t in sets]
        kj = torch.arange(L, device=dev)
        qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
        mask = (kj[None, None] <= qi[:, :, None])[:, None]      # B,1,s,L
        lib_ms = time_ms(torch, [
            lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
            for t in deq])
        del deq
        nbytes = (2 * b * s * hq * d * esz + live_keys * hkv * d * 2
                  + live_blocks * hkv * 4 * 2 + 4 * b * (mb + 1))
        ops = sum(4 * d * hq * min(p + si + 1, L)
                  for p in pos_list for si in range(s))
        bms, by = bound(nbytes, ops, BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record(name,
               f"B={b} s={s} Hq={hq} Hkv={hkv} D={d} block_len={bl} "
               f"max_blocks={mb} pool={n_blocks} pos={pos_list} "
               f"shared={[list(x) for x in share]} int8 K/V, "
               f"{str(dt)[6:]} q",
               err, f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms, lib_ms,
               bms, by, main, note=INT8_LIBRARY_NOTE)
        del sets, got, want

    # K4 weight-only int8 GEMM: a decode tick's 8 rows at every Llama-3-8B
    # projection shape (K, N), the row counts of short prefill waves at
    # gate/up, 256 rows (the kernel's row limit), then the tiny model's
    # float32 widths
    for dt, rows, k, n, main in (
            (bf16, 8, 4096, 4096, False),          # q_proj, o_proj
            (bf16, 8, 4096, 1024, False),          # k_proj, v_proj
            (bf16, 8, 4096, 14336, True),          # gate_proj, up_proj
            (bf16, 8, 14336, 4096, False),         # down_proj
            (bf16, 8, 4096, 128256, False),        # lm_head
            (bf16, 16, 4096, 14336, False),        # prefill waves
            (bf16, 64, 4096, 14336, False),
            (bf16, 128, 4096, 14336, False),
            (bf16, 256, 4096, 4096, False),
            (f32, 8, 64, 32, False),
            (f32, 8, 128, 64, False),
            (f32, 3, 64, 256, False)):
        atol, rtol = tols(dt)
        esz = 2 if dt == bf16 else 4
        sets = []
        for _ in range(copies(k * n)):
            w8 = int8_payload(k, n)
            sc = int8_scales(n) * 0.05
            sets.append((randn(rows, k, dtype=dt), w8, sc,
                         (w8.float() * sc).to(dt)))
        x, w8, sc, _ = sets[0]
        got = int8_matmul_cuda(x, w8, sc)
        want = int8_matmul_reference(x, w8, sc)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol)
        kfns = [lambda t=t: int8_matmul_cuda(t[0], t[1], t[2]) for t in sets]
        plain_ms = time_ms(torch, [
            lambda t=t: int8_matmul_reference(t[0], t[1], t[2])
            for t in sets], budget_ms=100.0)
        lib_ms = time_ms(torch, [lambda t=t: torch.matmul(t[0], t[3])
                                 for t in sets])
        nbytes = k * n + 4 * n + (rows * k + rows * n) * esz
        bms, by = bound(nbytes, 2 * rows * k * n,
                        BF16_FLOPS if dt == bf16 else F32_FLOPS)
        record("int8_matmul", f"rows={rows} K={k} N={n} int8 w, "
               f"{str(dt)[6:]} x", err, f"atol {atol} + rtol {rtol}", ok,
               kfns, plain_ms, lib_ms, bms, by, main,
               note=MATMUL_LIBRARY_NOTE)
        del sets, x, w8, sc, got, want

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
                                         llama3_8b_config,
                                         quantize_for_decode,
                                         tiny_llama_config)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.kv_cache import init_paged_kv_cache
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

    # a paged session: a 256-token prefix prefill written into scattered
    # pool blocks, a 64-token suffix prefill at per-row pos [128, 256]
    # (K2-paged), then 4 decode steps (K1-paged), all through the tables
    bl, nb_pool = 128, 10
    tables = torch.tensor([[6, 2, 0, 0], [3, 8, 5, 0]], dtype=torch.int32,
                          device=dev)
    prefix = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (b, 256)).astype(np.int32)).to(dev)
    suffix = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (b, 64)).astype(np.int32)).to(dev)
    suffix_pos = torch.tensor([128, 256], dtype=torch.int32, device=dev)

    def paged_forced(m, quantized=False):
        pool = init_paged_kv_cache(m.config, nb_pool, bl, quantized=quantized,
                                   device=dev)
        outs = []
        with torch.no_grad():
            logits, pool = m.decode_step(prefix, pool, 0,
                                         block_tables=tables)
            outs.append(logits.float())
            logits, pool = m.decode_step(suffix, pool, suffix_pos,
                                         block_tables=tables)
            outs.append(logits.float())
            pos = suffix_pos + 64
            for t in range(forced.shape[0]):
                tok = torch.from_numpy(forced[t][:, None]).to(dev)
                logits, pool = m.decode_step(tok, pool, pos,
                                             block_tables=tables)
                outs.append(logits.float())
                pos = pos + 1
        torch.cuda.synchronize()
        return outs

    got = teacher_forced(model)
    got_p = paged_forced(model)
    with reference_mode():
        want = teacher_forced(model)
        want_p = paged_forced(model)
    # the float32 truth: the same weights in float32 through the plain path
    model32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                               device=dev)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    with reference_mode():
        truth = teacher_forced(model32)
        truth_p = paged_forced(model32)
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

    # the paged session, under the same gate
    diff_p, err_kernel_p, err_plain_p = (worst(got_p, want_p),
                                         worst(got_p, truth_p),
                                         worst(want_p, truth_p))
    finite_p = all(bool(torch.isfinite(g).all().item()) for g in got_p)
    tol_p = 1.2 * err_plain_p
    emit({"phase": "model_paged", "config": "llama3_8b", "block_len": bl,
          "tables": tables.tolist(), "prefix_tokens": 256,
          "suffix_tokens": 64, "suffix_pos": suffix_pos.tolist(),
          "decode_steps": int(forced.shape[0]),
          "max_logit_diff_kernel_vs_plain": diff_p,
          "max_logit_err_kernel_vs_f32": err_kernel_p,
          "max_logit_err_plain_vs_f32": err_plain_p,
          "max_abs_logit": max(float(w.abs().max().item()) for w in truth_p),
          "tol_kernel_vs_f32": tol_p, "finite": finite_p})
    check(finite_p, "paged model logits are not finite")
    check(err_kernel_p <= tol_p,
          f"paged kernel path is {err_kernel_p} from the float32 model, the "
          f"plain path {err_plain_p} (tolerance {tol_p})")
    del got_p, want_p

    # the paged session on the int8 model (int8 weights: every projection,
    # the embedding and the LM head) over an int8 pool, against the same
    # float32 truth of the unquantized weights: the kernel path (K4,
    # K1-paged-int8, K2-paged-int8) must sit as close to it as the plain
    # path (dequantize-then-matmul, dequantized attention) does
    t0 = time.perf_counter()
    qmodel = quantize_for_decode(model)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    got_q = paged_forced(qmodel, quantized=True)
    with reference_mode():
        want_q = paged_forced(qmodel, quantized=True)
    diff_q, err_kernel_q, err_plain_q = (worst(got_q, want_q),
                                         worst(got_q, truth_p),
                                         worst(want_q, truth_p))
    finite_q = all(bool(torch.isfinite(g).all().item()) for g in got_q)
    tol_q = 1.2 * err_plain_q
    hbm_q, hbm_full = qmodel.hbm_bytes()
    emit({"phase": "model_int8", "config": "llama3_8b", "block_len": bl,
          "kv_cache_dtype": "int8", "int8_weights": True,
          "quantized_tensors": len(qmodel.quantized_names),
          "quantize_s": round(quant_s, 3), "hbm_bytes": hbm_q,
          "hbm_bytes_unquantized": hbm_full,
          "decode_steps": int(forced.shape[0]),
          "max_logit_diff_kernel_vs_plain": diff_q,
          "max_logit_err_kernel_vs_f32": err_kernel_q,
          "max_logit_err_plain_vs_f32": err_plain_q,
          "tol_kernel_vs_f32": tol_q, "finite": finite_q})
    check(finite_q, "int8 model logits are not finite")
    check(err_kernel_q <= tol_q,
          f"int8 kernel path is {err_kernel_q} from the float32 model, the "
          f"plain path {err_plain_q} (tolerance {tol_q})")
    del got_q, want_q, truth_p

    # tiny float32 engine: kernels on the card vs plain versions on the CPU
    tiny = tiny_llama_config()
    prompts = [rng.randint(0, tiny.vocab_size, n).astype(np.int32)
               for n in (5, 9, 17, 3, 30, 11)]

    tiny_cpu = LlamaForCausalLM(tiny, device="cpu", seed=1)
    tiny_card = copy.deepcopy(tiny_cpu).to(dev)   # the same weights

    def serve(m, device, reqs=prompts, **kw):
        eng = ServingEngine(m, num_slots=2, max_length=64, device=device,
                            **kw)
        rids = [eng.submit(p, max_new_tokens=8) for p in reqs]
        out = dict(eng.drain())
        return [out[r] for r in rids], eng

    on_card, on_cpu = serve(tiny_card, "cuda")[0], serve(tiny_cpu, "cpu")[0]
    emit({"phase": "model_tiny_f32", "requests": len(prompts),
          "identical": on_card == on_cpu})
    check(on_card == on_cpu,
          f"tiny f32 engine differs card vs cpu: {on_card} vs {on_cpu}")

    # the tiny PAGED engine (block_len 16): two more prompts open with one
    # 20-token system prompt, so a suffix prefill runs at pos 16
    sys_p = rng.randint(0, tiny.vocab_size, 20).astype(np.int32)
    paged_prompts = prompts + [
        np.concatenate([sys_p, rng.randint(0, tiny.vocab_size, n).astype(
            np.int32)]) for n in (4, 13)]
    paged_kw = dict(paged=True, block_len=16)
    p_card, eng_card = serve(tiny_card, "cuda", paged_prompts, **paged_kw)
    p_cpu, _ = serve(tiny_cpu, "cpu", paged_prompts, **paged_kw)
    contiguous_card, _ = serve(tiny_card, "cuda", paged_prompts)
    hits = eng_card.kv.stats["prefix_hit_tokens"]
    emit({"phase": "model_tiny_f32_paged", "requests": len(paged_prompts),
          "block_len": 16, "prefix_hit_tokens": hits,
          "identical_card_vs_cpu": p_card == p_cpu,
          "identical_paged_vs_contiguous_card": p_card == contiguous_card})
    check(hits > 0, "tiny paged engine adopted no prefix block")
    check(p_card == p_cpu,
          f"tiny f32 paged engine differs card vs cpu: {p_card} vs {p_cpu}")
    check(p_card == contiguous_card,
          f"tiny f32 paged engine differs from the contiguous engine on the "
          f"card: {p_card} vs {contiguous_card}")

    # the tiny int8 engines (int8 KV + int8 weights, quantized once on the
    # CPU and copied to the card), contiguous and paged: card vs CPU
    q_cpu = quantize_for_decode(tiny_cpu, min_elems=TINY_MIN_ELEMS)
    q_card = copy.deepcopy(q_cpu).to(dev)
    int8_kw = dict(kv_cache_dtype="int8", int8_weights=True)
    for layout, reqs, kw in (("contiguous", prompts, int8_kw),
                             ("paged", paged_prompts,
                              dict(int8_kw, **paged_kw))):
        i_card, _ = serve(q_card, "cuda", reqs, **kw)
        i_cpu, _ = serve(q_cpu, "cpu", reqs, **kw)
        emit({"phase": "model_tiny_f32_int8", "layout": layout,
              "requests": len(reqs),
              "quantized_tensors": len(q_cpu.quantized_names),
              "identical_card_vs_cpu": i_card == i_cpu})
        check(i_card == i_cpu,
              f"tiny f32 int8 {layout} engine differs card vs cpu: "
              f"{i_card} vs {i_cpu}")
    return model, qmodel


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
    for name in CONTIGUOUS_PATH:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
        kernels[name]["launches"] = launches[name]
    return eng


def paged_serving_prompts(vocab: int):
    """16 requests: 8 open with one shared 1536-token system prompt (12
    full blocks of 128) and continue with their own suffixes, 8 are unique
    prompts; the two kinds alternate in arrival order."""
    import numpy as np
    rng = np.random.RandomState(2)
    system = rng.randint(0, vocab, 1536).astype(np.int32)
    suffixes = (5, 300, 37, 700, 12, 128, 1023, 90)
    uniques = (8, 1200, 400, 64, 2000, 260, 17, 900)
    prompts = []
    for n_suf, n_uni in zip(suffixes, uniques):
        prompts.append(np.concatenate(
            [system, rng.randint(0, vocab, n_suf).astype(np.int32)]))
        prompts.append(rng.randint(0, vocab, n_uni).astype(np.int32))
    return prompts


def phase_serving_paged(torch, model, kernels):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, num_slots=8, max_length=4096,
                        prefill_batch=4, paged=True, block_len=128,
                        num_blocks=PAGED_POOL_BLOCKS, device="cuda")
    prompts = paged_serving_prompts(model.config.vocab_size)
    new_tokens = 32
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    out = dict(eng.drain())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    paths = {f"{op}/{path}": n for (op, path), n in
             _dispatch.kernel_paths.items()}
    m = eng.metrics()
    kv = m["kv_cache"]
    ntok = sum(len(out[r]) for r in rids)
    emit({"phase": "serving_paged", "requests": len(rids),
          "prompt_lengths": [int(p.size) for p in prompts],
          "block_len": 128, "num_blocks": PAGED_POOL_BLOCKS,
          "new_tokens": new_tokens, "tokens": ntok,
          "wall_s": round(wall, 4), "tok_per_s": round(ntok / wall, 2),
          "decode_step_ms": m["decode_step_ms"], "ttft_ms": m["ttft_ms"],
          "tpot_ms": m["tpot_ms"], "prefill_wave_ms": m["prefill_wave_ms"],
          "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"],
          "prefill_tokens_computed": m["prefill_tokens_computed"],
          "prefill_tokens_total": m["prefill_tokens_total"],
          "kv_cache": kv, "launches": launches, "routes": paths})
    vocab = model.config.vocab_size
    for r in rids:
        check(len(out[r]) == new_tokens,
              f"request {r} returned {len(out[r])} tokens")
        check(all(0 <= t < vocab for t in out[r]),
              f"request {r} returned a token outside the vocabulary")
    check(kv["prefix_hit_tokens"] > 0, "no prefix hit on the shared prompt")
    check(m["prefill_tokens_computed"] < m["prefill_tokens_total"],
          "the prefix cache saved no prefill token")
    check(kv["evictions"] >= 1, "the pool evicted no block")
    check(kv["admission_blocked"] >= 1, "no admission waited for blocks")
    check(kv["blocks_in_use"] == 0, "blocks still in use after the drain")
    check(launches["decode_attention_paged"]
          == LAYERS_8B * m["decode_ticks"],
          f"K1-paged launched {launches['decode_attention_paged']} times "
          f"for {m['decode_ticks']} decode ticks")
    check(launches["flash_attention_fwd_paged"]
          == LAYERS_8B * m["prefill_waves"],
          f"K2-paged launched {launches['flash_attention_fwd_paged']} times "
          f"for {m['prefill_waves']} waves")
    check(launches["decode_attention"] == 0
          and launches["flash_attention_fwd"] == 0,
          "a contiguous attention kernel ran on the paged path")
    check(launches["rms_norm"] > 0, "RMSNorm kernel not launched")
    plain = {k: n for k, n in paths.items() if k.endswith("/plain")}
    check(not plain, f"plain routes taken on the card: {plain}")
    for name in ("decode_attention_paged", "flash_attention_fwd_paged"):
        kernels[name]["launches"] = launches[name]
    return eng


def _serve_8b(torch, model, prompts, new_tokens=32, **kw):
    """One 8B-width serving run with every launch and route counter reset
    just before and read just after.  Returns (engine, outputs in submit
    order, wall seconds, launches, routes)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, num_slots=8, max_length=4096,
                        prefill_batch=4, device="cuda", **kw)
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    out = dict(eng.drain())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    vocab = model.config.vocab_size
    outs = [out[r] for r in rids]
    for r, o in zip(rids, outs):
        check(len(o) == new_tokens, f"request {r} returned {len(o)} tokens")
        check(all(0 <= t < vocab for t in o),
              f"request {r} returned a token outside the vocabulary")
    return eng, outs, wall, launches, routes


def _check_int8_launches(m, launches, routes, attention):
    """The int8 engine's launch contract: each kernel of ``attention``
    (name -> 'tick' or 'wave') 32 times a decode tick or a wave, K4 at
    least 7 x 32 + 1 times a decode tick, every other attention kernel
    never, RMSNorm on every layer, no plain route."""
    per = {"tick": m["decode_ticks"], "wave": m["prefill_waves"]}
    for name, unit in attention.items():
        check(launches[name] == LAYERS_8B * per[unit],
              f"{name} launched {launches[name]} times for {per[unit]} "
              f"{unit}s")
    others = [n for n in ("decode_attention", "flash_attention_fwd",
                          "decode_attention_paged",
                          "flash_attention_fwd_paged",
                          "decode_attention_int8",
                          "decode_attention_paged_int8",
                          "flash_attention_fwd_paged_int8")
              if n not in attention and launches[n]]
    check(not others, f"attention kernels off this path ran: {others}")
    check(launches["int8_matmul"] >= K4_PER_TICK * m["decode_ticks"],
          f"K4 launched {launches['int8_matmul']} times for "
          f"{m['decode_ticks']} decode ticks")
    check(launches["rms_norm"] > 0, "RMSNorm kernel not launched")
    plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
    check(not plain, f"plain routes taken on the card: {plain}")


def phase_serving_int8(torch, qmodel, kernels, paged_metrics):
    """Phase 4c: phase 4b's engine, requests and pool, int8 KV + int8
    weights; the schedule must be phase 4b's."""
    kw = dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS,
              kv_cache_dtype="int8", int8_weights=True)
    prompts = paged_serving_prompts(qmodel.config.vocab_size)
    eng, outs, wall, launches, routes = _serve_8b(torch, qmodel, prompts,
                                                  **kw)
    m = eng.metrics()
    kv = m["kv_cache"]
    ntok = sum(len(o) for o in outs)
    hbm_q, hbm_full = qmodel.hbm_bytes()
    schedule = {"prefill_waves": m["prefill_waves"],
                "decode_ticks": m["decode_ticks"],
                "prefill_tokens_computed": m["prefill_tokens_computed"],
                "prefill_tokens_total": m["prefill_tokens_total"],
                "evictions": kv["evictions"],
                "admission_blocked": kv["admission_blocked"]}
    emit({"phase": "serving_int8", "requests": len(prompts),
          "block_len": 128, "num_blocks": PAGED_POOL_BLOCKS,
          "kv_cache_dtype": "int8", "int8_weights": True,
          "new_tokens": 32, "tokens": ntok, "wall_s": round(wall, 4),
          "tok_per_s": round(ntok / wall, 2),
          "decode_step_ms": m["decode_step_ms"], "ttft_ms": m["ttft_ms"],
          "tpot_ms": m["tpot_ms"], "prefill_wave_ms": m["prefill_wave_ms"],
          "schedule": schedule, "kv_cache": kv,
          "pool_bytes": eng.cache_hbm_bytes,
          "model_hbm_bytes": hbm_q, "model_hbm_bytes_unquantized": hbm_full,
          "launches": launches, "routes": routes})
    check(schedule == PAGED_SCHEDULE,
          f"phase 4c schedule {schedule} is not {PAGED_SCHEDULE}")
    check(all(schedule[k] == (paged_metrics["kv_cache"] if k in (
        "evictions", "admission_blocked") else paged_metrics)[k]
        for k in schedule), "phase 4c schedule differs from phase 4b's")
    check(kv["kv_dtype"] == "int8" and kv["quantized_blocks"] > 0,
          "the int8 pool holds no int8 block")
    check(kv["blocks_in_use"] == 0, "blocks still in use after the drain")
    _check_int8_launches(m, launches, routes,
                         {"decode_attention_paged_int8": "tick",
                          "flash_attention_fwd_paged_int8": "wave"})
    for name in ("decode_attention_paged_int8",
                 "flash_attention_fwd_paged_int8", "int8_matmul"):
        kernels[name]["launches"] = launches[name]
    del eng


def phase_serving_int8_contiguous(torch, qmodel, kernels, metrics4):
    """Phase 4d: phase 4's engine and requests, int8 KV + int8 weights."""
    prompts = serving_prompts(qmodel.config.vocab_size)
    eng, outs, wall, launches, routes = _serve_8b(
        torch, qmodel, prompts, kv_cache_dtype="int8", int8_weights=True)
    m = eng.metrics()
    ntok = sum(len(o) for o in outs)
    emit({"phase": "serving_int8_contiguous", "requests": len(prompts),
          "kv_cache_dtype": "int8", "int8_weights": True, "new_tokens": 32,
          "tokens": ntok, "wall_s": round(wall, 4),
          "tok_per_s": round(ntok / wall, 2),
          "decode_step_ms": m["decode_step_ms"], "ttft_ms": m["ttft_ms"],
          "tpot_ms": m["tpot_ms"], "prefill_wave_ms": m["prefill_wave_ms"],
          "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"],
          "cache_bytes": eng.cache_hbm_bytes, "launches": launches,
          "routes": routes})
    check((m["prefill_waves"], m["decode_ticks"])
          == (metrics4["prefill_waves"], metrics4["decode_ticks"]),
          "phase 4d schedule differs from phase 4's")
    _check_int8_launches(m, launches, routes,
                         {"decode_attention_int8": "tick",
                          "flash_attention_fwd": "wave"})
    kernels["decode_attention_int8"]["launches"] = \
        launches["decode_attention_int8"]
    del eng


def device_us(prof, n: int):
    """Device time per call (us) by kernel name from a profiler window of
    ``n`` calls."""
    return {k[:60]: round(t / n, 3) for t, k, _ in kernel_rows(prof)}


def phase_profile(torch, model, qmodel):
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

    # decode ticks of 8 busy slots: the contiguous engine on phase 4's
    # prompts, then the paged engine on phase 4b's, then phase 4c's int8
    # engine on them
    paged_kw = dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS)
    for phase, m, kw, prompts in (
            ("profile", model, {}, serving_prompts(model.config.vocab_size)),
            ("profile_paged", model, paged_kw,
             paged_serving_prompts(model.config.vocab_size)),
            ("profile_int8_paged", qmodel,
             dict(paged_kw, kv_cache_dtype="int8", int8_weights=True),
             paged_serving_prompts(model.config.vocab_size))):
        eng = ServingEngine(m, num_slots=8, max_length=4096,
                            prefill_batch=4, device="cuda", **kw)
        for p in prompts[:8]:
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
        rows = kernel_rows(prof)
        total = sum(t for t, _, _ in rows)
        host = sorted((ev.self_cpu_time_total, ev.key, ev.count)
                      for ev in prof.key_averages()
                      if ev.key and ev.key.startswith("aten::"))[::-1]
        emit({"phase": phase, "ticks": 5, "active_slots": eng.num_active,
              "wall_ms": round(wall_ms, 3),
              "device_kernel_ms": round(total / 1e3, 3),
              "device_busy_share": round(total / 1e3 / wall_ms, 4),
              "top": [{"kernel": k[:90], "ms": round(t / 1e3, 3),
                       "calls": c} for t, k, c in rows[:15]],
              "host_self_top": [{"op": k, "ms": round(t / 1e3, 3),
                                 "calls": c} for t, k, c in host[:15]]})
        eng.drain()
        del eng


# -- phase 5 ------------------------------------------------------------------------

def packed_batch(vocab: int, rows: int, seq: int, seed: int, lo: int = 3,
                 hi: int = 8):
    """The dryrun's packing recipe at any length: next-token ids, rows
    packed with lo..hi documents (:func:`packed_segments`), positions
    restarting at every document (numpy arrays)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (rows, seq + 1)).astype(np.int64)
    seg = packed_segments(rows, seq, seed + 1, lo, hi)
    pos = np.zeros_like(seg)
    for r in range(rows):
        for c in range(1, seq):
            pos[r, c] = 0 if seg[r, c] != seg[r, c - 1] else pos[r, c - 1] + 1
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:],
            "segment_ids": seg, "position_ids": pos}


def _train_tiny(torch, model, batches, dev):
    """Four steps of the tiny model's train step on ``dev``; (losses,
    {name: float32 parameter on the CPU})."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.optimizer import AdamW
    step = build_train_step(model, AdamW(1e-3, weight_decay=0.01))
    losses = [float(step({k: torch.from_numpy(v).to(dev)
                          for k, v in b.items()})) for b in batches]
    return losses, {k: p.detach().float().cpu()
                    for k, p in model.named_parameters()}


# kernel-name fragments of each class in the training window
STEP_CLASSES = (("attention (K2, K5, K6)", ("flash_attention", "bwd_dq_",
                                            "bwd_dkv_")),
                ("rms_norm (K3)", ("rms_norm",)),
                ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")))


def profile_step(torch, step, opt, batch, phase: str) -> None:
    """torch.profiler over one train step: device time by kernel class and
    name, the optimizer's share (``opt.apply`` under a profiler range, the
    clip included), the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    apply = opt.apply

    def traced_apply(*args, **kwargs):
        with record_function("optimizer.apply"):
            return apply(*args, **kwargs)

    opt.apply = traced_apply
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(batch))
        wall_ms = (time.perf_counter() - t0) * 1e3
    del opt.apply                   # the class's method again
    rows = kernel_rows(prof)
    total = sum(t for t, _, _ in rows)
    classes = {name: 0.0 for name, _ in STEP_CLASSES}
    classes["other (elementwise, reductions, copies)"] = 0.0
    for t, k, _ in rows:
        name = next((n for n, frags in STEP_CLASSES
                     if any(f in k for f in frags)),
                    "other (elementwise, reductions, copies)")
        classes[name] += t
    opt_us = sum(_device_time(ev) for ev in prof.key_averages()
                 if ev.key == "optimizer.apply"
                 and ev.device_type != torch.autograd.DeviceType.CUDA)
    emit({"phase": phase, "wall_ms": round(wall_ms, 3),
          "device_kernel_ms": round(total / 1e3, 3),
          "device_busy_share": round(total / 1e3 / wall_ms, 4),
          "optimizer_apply_device_ms": round(opt_us / 1e3, 3),
          "by_class_ms": {k: round(v / 1e3, 3) for k, v in classes.items()},
          "top": [{"kernel": k[:90], "ms": round(t / 1e3, 3), "calls": c}
                  for t, k, c in rows[:20]]})


def phase_training(torch, kernels, profile: bool = False):
    """Phase 5: the single-GPU train step at the Llama-3-8B width, cut to
    TRAIN_LAYERS layers, recompute on, packed batches."""
    import numpy as np
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama3_8b_config,
                                         tiny_llama_config)
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_8b_config(num_hidden_layers=TRAIN_LAYERS, recompute=True)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in packed_batch(
        cfg.vocab_size, TRAIN_ROWS, TRAIN_SEQ, seed=5).items()}
    micro = {k: v[:TRAIN_ROWS // TRAIN_ACCUM] for k, v in batch.items()}

    # (a) step-1 gradients of one micro-batch: kernel path, plain path and
    # the float32 truth (the same weights in float32 on the plain path);
    # the truth first, then each path's error summed tensor by tensor
    def grads(m):
        params = [p for p in m.parameters()]
        loss = m.compute_loss(**micro)
        return float(loss.detach()), torch.autograd.grad(loss, params)

    model32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                               device=dev)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    with reference_mode():
        loss32, truth = grads(model32)
    del model32
    torch.cuda.empty_cache()
    truth_sq = [float(t.pow(2).sum()) for t in truth]

    def errors(gs):
        return [float((g.float() - t).pow(2).sum())
                for g, t in zip(gs, truth)]

    loss_k, g = grads(model)
    err_k = errors(g)
    del g
    with reference_mode():
        loss_p, g = grads(model)
    err_p = errors(g)
    del g, truth
    torch.cuda.empty_cache()
    names = [n for n, _ in model.named_parameters()]
    rel_k = math.sqrt(sum(err_k) / sum(truth_sq))
    rel_p = math.sqrt(sum(err_p) / sum(truth_sq))
    per_k = [math.sqrt(e / max(t, 1e-30)) for e, t in zip(err_k, truth_sq)]
    per_p = [math.sqrt(e / max(t, 1e-30)) for e, t in zip(err_p, truth_sq)]
    worst = max(range(len(names)), key=lambda i: per_k[i] / max(per_p[i],
                                                                1e-30))
    tol = 1.2 * rel_p
    emit({"phase": "training_grads", "config": "llama3_8b",
          "layers": TRAIN_LAYERS, "params": n_params,
          "init_s": round(init_s, 3), "micro_batch": list(
              micro["input_ids"].shape),
          "documents": len(torch_counts(micro["segment_ids"])),
          "loss_kernel": loss_k, "loss_plain": loss_p, "loss_f32": loss32,
          "grad_rel_l2_kernel_vs_f32": rel_k,
          "grad_rel_l2_plain_vs_f32": rel_p, "tol_kernel_vs_f32": tol,
          "max_tensor_rel_l2_kernel": max(per_k),
          "max_tensor_rel_l2_plain": max(per_p),
          "worst_tensor_ratio": {"name": names[worst],
                                 "kernel": per_k[worst],
                                 "plain": per_p[worst]}})
    check(all(math.isfinite(x) for x in (loss_k, loss_p, rel_k)),
          "training gradients are not finite")
    check(rel_k <= tol,
          f"kernel-path gradients are {rel_k} from the float32 truth, the "
          f"plain path's {rel_p} (tolerance {tol})")
    # and tensor by tensor, so a wrong dq or dk/dv of one projection cannot
    # hide under the embedding's and LM head's share of the sum
    bad = {names[i]: (per_k[i], per_p[i]) for i in range(len(names))
           if per_k[i] > 1.2 * per_p[i] + GRAD_TENSOR_FLOOR}
    check(not bad, f"gradients beyond 1.2x the plain path's error + "
                   f"{GRAD_TENSOR_FLOOR}: {bad}")

    # (b) + (c): TRAIN_STEPS steps on the packed batch, every launch and
    # route counter reset just before and read just after
    opt = AdamW(lr.LinearWarmup(3e-4, 2), beta2=0.95, epsilon=1e-5,
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    step = build_train_step(model, opt, grad_accum_steps=TRAIN_ACCUM)
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    losses, step_ms = [], []
    torch.cuda.synchronize()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))      # float() synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    state_bytes = sum(t.numel() * t.element_size()
                      for k, v in opt.state_dict().items() if k != "step"
                      for t in v.values())
    tokens = TRAIN_ROWS * TRAIN_SEQ
    pairs = causal_pairs(batch["segment_ids"], TRAIN_ROWS, TRAIN_SEQ)
    matmul_params = n_params - cfg.vocab_size * cfg.hidden_size \
        - sum(p.numel() for n, p in model.named_parameters()
              if n.endswith("norm.weight"))
    model_flops = (6 * matmul_params * tokens
                   + 12 * cfg.head_dim * cfg.num_attention_heads * pairs
                   * TRAIN_LAYERS)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    emit({"phase": "training", "config": "llama3_8b",
          "layers": TRAIN_LAYERS, "recompute": True, "params": n_params,
          "batch": [TRAIN_ROWS, TRAIN_SEQ], "grad_accum_steps": TRAIN_ACCUM,
          "documents": len(torch_counts(batch["segment_ids"])),
          "optimizer": "AdamW(LinearWarmup(3e-4, 2), beta2=0.95, eps=1e-5, "
                       "wd=0.1, ClipGradByGlobalNorm(1.0))",
          "losses": losses, "step_ms": step_ms, "step_ms_median": steady,
          "tokens_per_s": tokens / (steady / 1e3),
          "model_flops_per_step": model_flops,
          "model_flops_share_of_989T": model_flops / (steady / 1e3)
          / BF16_FLOPS,
          "optimizer_state_bytes": state_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "routes": routes})
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0],
          f"training did not lower the loss: {losses}")
    per_step = {"flash_attention_fwd": 2 * TRAIN_ACCUM * TRAIN_LAYERS,
                "flash_attention_bwd_dq": TRAIN_ACCUM * TRAIN_LAYERS,
                "flash_attention_bwd_dkv": TRAIN_ACCUM * TRAIN_LAYERS}
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
              f"steps, expected {n} a step")
    check(launches["rms_norm"] > 0, "RMSNorm kernel not launched")
    plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
    check(not plain, f"plain routes taken on the card: {plain}")
    for name in TRAIN_KERNELS:
        kernels[name]["launches"] = launches[name]
    if profile:
        profile_step(torch, step, opt, batch, "profile_training")
    del step, opt, model, batch, micro
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the tiny float32 model: 4 steps on the card (kernels) and on the
    # CPU (plain versions) from the same weights, unpacked and packed
    # batches (the dryrun's (8, 17) ids).  Losses: rtol 1e-5 (float32 sum
    # order).  Parameters: the difference's L2 norm within 1e-3 of the 4
    # steps' update norm -- Adam normalises each element by its own RMS,
    # so where two steps' gradients nearly cancel, sum-order noise reaches
    # single elements at a few percent of lr, while a wrong kernel moves
    # the whole update
    tiny = tiny_llama_config(recompute=True)
    base = LlamaForCausalLM(tiny, device="cpu", seed=3)
    init = {k: p.detach().clone() for k, p in base.named_parameters()}
    for packed in (False, True):
        rng = np.random.RandomState(11)
        batches = []
        for i in range(4):
            if packed:
                batches.append(packed_batch(tiny.vocab_size, 8, 16, seed=20 + i,
                                            lo=1, hi=3))
            else:
                ids = rng.randint(0, tiny.vocab_size, (8, 17))
                batches.append({"input_ids": ids[:, :-1],
                                "labels": ids[:, 1:]})
        ops.reset_launch_counts()
        card_l, card_p = _train_tiny(torch, copy.deepcopy(base).to(dev),
                                     batches, dev)
        launches = ops.launch_counts()
        cpu_l, cpu_p = _train_tiny(torch, copy.deepcopy(base), batches,
                                   torch.device("cpu"))
        diff = math.sqrt(sum(float((card_p[k] - cpu_p[k]).pow(2).sum())
                             for k in cpu_p))
        upd = math.sqrt(sum(float((cpu_p[k] - init[k]).pow(2).sum())
                            for k in cpu_p))
        max_abs = max(float((card_p[k] - cpu_p[k]).abs().max())
                      for k in cpu_p)
        loss_ok = all(abs(a - b) <= 1e-5 * abs(b)
                      for a, b in zip(card_l, cpu_l))
        emit({"phase": "training_tiny_f32", "packed": packed,
              "losses_card": card_l, "losses_cpu": cpu_l,
              "param_diff_l2": diff, "update_l2": upd,
              "param_max_abs_diff": max_abs,
              "launches": {k: launches[k] for k in (
                  "flash_attention_fwd", *TRAIN_KERNELS)}})
        check(loss_ok, f"tiny f32 losses differ card vs cpu: {card_l} vs "
                       f"{cpu_l}")
        check(diff <= 1e-3 * upd,
              f"tiny f32 parameters differ card vs cpu: {diff} against an "
              f"update of {upd}")
        check(all(launches[k] > 0 for k in TRAIN_KERNELS),
              "the tiny train step ran no backward kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows after phases 4 and 5")
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
    model, qmodel = phase_model(torch)
    eng = phase_serving(torch, model, kernels)
    metrics4 = eng.metrics()
    del eng
    torch.cuda.empty_cache()
    eng = phase_serving_paged(torch, model, kernels)
    metrics4b = eng.metrics()
    del eng
    torch.cuda.empty_cache()
    phase_serving_int8(torch, qmodel, kernels, metrics4b)
    torch.cuda.empty_cache()
    phase_serving_int8_contiguous(torch, qmodel, kernels, metrics4)
    torch.cuda.empty_cache()
    if args.profile:
        phase_profile(torch, model, qmodel)
    del model, qmodel
    gc.collect()
    torch.cuda.empty_cache()
    phase_training(torch, kernels, profile=args.profile)
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
