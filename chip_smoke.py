#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds every kernel of the serving, sampling and training paths from
the sources in the checkout, holds each against its plain PyTorch version,
runs the model at the full Llama-3-8B width, serves requests through the
engine, generates with ``generate`` (greedy, sampled, beam, int8), samples
and trains DiT-XL/2, generates with and trains Qwen2-VL at its default
widths and trains a 4-layer cut of the Llama model.  Every phase prints one JSON line;
any failed check raises, so the script exits non-zero.  Phases:

  1. card      — ``nvidia-smi`` name and power limit, torch/CUDA versions,
                 the kernels' build time (one ``nvcc`` per source, all at
                 once) and ptxas's registers / spill bytes per library;
                 fails if ptxas reports that it serialised the
                 ``wgmma.mma_async`` instructions of any kernel (named),
                 or if a build of the Hopper K1 kernel (K1, K1-int8,
                 K1-paged, K1-paged-int8) spills or fits no CTA on an SM
                 (``k1_mma``: registers, spills, CTAs an SM);
  2. kernels   — K1 flash-decode (also with every row at the last
                 position and a 4-token window; the same bits on two
                 calls), K2 flash-attention forward and K3
                 RMSNorm at the serving path's Llama-3-8B shapes (bf16),
                 then K1-paged (decode tick; block_len 128, 16 and 8, and
                 a batch whose every row is at the last position; the
                 same bits on two calls) and K2-paged (suffix prefill,
                 block_len 128 and 64) on pools built so a kernel cannot
                 pass by accident (physical blocks shuffled, rows sharing
                 their first blocks, null-filled dead tails), then the
                 int8 builds: K1-int8 over a contiguous int8 cache with
                 128-token scale granules (and 8-token ones, every row at
                 4095, the same bits on two calls), K1-paged-int8 and
                 K2-paged-int8 over int8 pools with per-block scales, and
                 K4, the weight-only int8 GEMM, at every Llama-3-8B
                 projection shape (8 rows), at the row counts a prefill
                 wave sends it (16, 64, 128 rows of gate/up) and at 256
                 rows (its limit); K2 with
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
                 gradient) and K5 / K6 giving the same bits twice; then
                 K2-paged and K2-paged-int8 over the contiguous cache's
                 identity view (the chunked engine's 256-token chunk into
                 one row of an 8-row, 4096-position cache at pos 0, 1024,
                 3840; int8 with 128-token granules) and the crossover
                 of K1 and that route at s = 4, 16, 64, 256 (``crossover``
                 line, beside the port's ``CONTIGUOUS_Q_TILED_MIN``); then
                 the speculative verify window (8 rows of s = 5 at the
                 main depths): K1, K1-int8, K2-paged, K2-paged-int8 (the
                 engine's routes) and K1-paged, K1-paged-int8 called at
                 the same window (``verify_window`` line); then K2 at
                 the head dims below 128: bf16 D 72 at the dit phase's
                 shape (B 16, S 256, 16 heads, full attention), causal
                 GQA at a ragged Sq 77 over Skv 61 (dead rows), the
                 ring-hop segmented form, bf16 D 64, float32 D 72 and 64,
                 then K5 / K6 at those head dims: bf16 D 72 at the
                 dit_train step's shape (B 32, S 256, 16 heads, full
                 attention) and, at D 72 and 64, causal GQA at Sq 77 over
                 Skv 61, the ring-hop form and packed documents at S 300
                 (dead rows exact, the same bits twice), float32 at 72
                 and 64; then Qwen2-VL's shapes: K1 at its decoder's
                 one query head a KV head (Hq = Hkv = 8, D 128, a cache
                 of 96, B 4 and 16), K2 not causal at bf16
                 D 64 over the tower's B 4 x 256 patches x 4 heads, K2
                 cross-attention at D 128 over 256 patches at Sq 1 (a
                 decode step) and Sq 64 (the prefill), K5 / K6 at D 64
                 at the tower's training shape and at the cross shape
                 (Sq 64, Skv 256, D 128); each also at the tiny model's
                 float32 shapes:
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
                 (kernels, its decode step one CUDA graph replayed every
                 tick) against the same engine on the CPU (plain
                 versions): greedy tokens must be identical, and the
                 tiny PAGED engine on the card must match both the paged
                 engine on the CPU and the contiguous engine on the card;
                 the tiny int8 engines (int8 KV and int8 weights,
                 contiguous and paged) must match themselves on the CPU;
                 the tiny chunked engines (8-token chunks; contiguous and
                 paged under both ``chunk_policy`` values, int8
                 contiguous) must match themselves on the CPU; so must
                 the tiny speculative engines (``spec_k`` 4: n-gram
                 contiguous, paged and chunked, and a 1-layer draft
                 model), their ``metrics()["spec"]`` counters too;
                 every engine on the card must have built its decode
                 step once (``step_traces`` 1; chunked: its mixed step
                 and its decode step once each), replayed a graph
                 once a tick (``graph_replays``) and a prefill graph
                 once a wave (``prefill_graph_replays``), and built as
                 many prefill steps as the same engine on the CPU
                 (``prefill_traces``);
  4. serving   — ``ServingEngine(num_slots=8, max_length=4096,
                 prefill_batch=4)`` on 12 requests of 5..1500 prompt
                 tokens, 32 new tokens each; every launch counter is reset
                 just before and read just after (K1 32 a decode tick, no
                 plain route); tok/s, step ms, TTFT.  The engine builds
                 its decode step once at construction (a warm-up and one
                 CUDA-graph capture) and replays it every tick:
                 ``step_traces`` must be 1 and ``graph_replays`` the
                 decode ticks; each wave key (bucket, rows) is built
                 once as a graph on its first use and replayed by every
                 wave: ``prefill_traces`` must be the number of distinct
                 keys the waves used and ``prefill_graph_replays`` the
                 waves; then its ``eager_twin`` serves the same
                 requests with the steps run eagerly
                 (``disable_graphs()``): every request's tokens, every
                 launch count and every route count must be the graphed
                 engine's; both runs' tok/s and step ms are reported.
                 Phases 4b-4d do the same.  Phases 4 and 4d then serve
                 their requests again on the same engine (``warm``): no
                 new build, a replay a wave, the cold pass's tokens;
                 tok/s, TTFT, ``prefill_wave_ms`` and peak allocated
                 memory of both passes;
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
  4e-4g. chunked prefill (``chunked=True, prefill_chunk=256``), each with
                 its eager twin: 4e ``serving_chunked`` (phase 4's
                 requests, contiguous bf16), 4f ``serving_chunked_paged``
                 (phase 4b's requests and pool, ``chunk_policy="decode"``,
                 prefix hits required), 4g ``serving_chunked_int8``
                 (phase 4's requests, int8 KV and weights).  Gates:
                 ``step_traces`` 1 and the decode step built once, one
                 graph replay a tick, tokens / launches / routes equal to
                 the twin's, K2-paged(-int8) 32 launches a chunk (the
                 contiguous chunk through the identity view), the decode
                 kernel 32 a tick, no other attention kernel, no plain
                 route (K4 as in 4c with int8 weights); reported: tok/s,
                 TTFT, TPOT, ``mixed_step_ms`` and ``decode_step_ms``,
                 and how many requests' tokens equal the wave phase's;
  4h-4k. speculative decode (``spec_decode=True, spec_k=4``), each with
                 its eager twin: 4h ``serving_spec`` (phase 4's engine
                 and requests), 4i ``serving_spec_paged`` (phase 4b's
                 requests and pool), 4j ``serving_spec_int8`` (4i with
                 int8 KV and weights): half the requests draft with a
                 scripted drafter that replays the base phase's output
                 (every other one corrupted at column 2), half with the
                 n-gram drafter; 4k ``serving_spec_chunked_model`` (phase
                 4e's chunked engine with ``drafter="model"``, the
                 target's first 2 layers by ``draft_model_from``).
                 Gates: the verify step (and 4k's mixed step, draft step
                 and ingest step) built once, one replay a tick, tokens /
                 launches / routes / spec counters equal to the twin's;
                 4h-4j: ``drafted_tokens``, ``draft_hit_tokens`` and
                 ``rollbacks`` > 0, K1 (4h) or K2-paged(-int8) (4i, 4j)
                 32 a verify tick and the wave kernel 32 a wave, no other
                 attention kernel, no plain route, paged: prefix hits and
                 no block in use after the drain, int8 weights: K4 as in
                 4c; 4k: ``drafted_tokens`` > 0, K1 32 a tick plus 8 a
                 draft step, K2-paged over the identity view 32 a chunk
                 plus 2 an ingest step.  Reported beside the base phase:
                 tok/s, TPOT p50, step ms p50, the mean accepted tokens a
                 step, peak memory, tokens equal to the base phase's.  4h
                 then serves a ``warm`` pass on the same engine whose
                 scripted drafters replay 4h's own cold output (no new
                 build, a replay a tick and a wave, hits > 0), reported
                 beside phase 4's warm pass;
  generate.    — phase 3's Llama-3-8B model (bf16, 32 layers) through
                 ``generate``: greedy (B 4, prompt 128, 64 new tokens),
                 sampled (temperature 0.8, top_k 50, top_p 0.9), beam
                 search (B 2, K 4, 32 new tokens, an EOS id) and greedy
                 on the int8 model (K4); each key built once (its decode
                 step one CUDA graph, replayed for every token after the
                 first), cold and warm, beside its eager twin: the same
                 tokens bit for bit, launches K1 32 a decode step, K2 32
                 a prefill, K3 65 a pass, K4 225 a decode step (int8), no
                 plain route; the greedy run's first-step logits within
                 1.2x the plain path's error against a float32 copy;
                 tokens/s and ms a token on a line that names the card;
  dit.         — after the serving models are freed: DiT-XL/2 (28 blocks,
                 hidden 1152, 16 heads of 72, 32 x 32 x 4 latents, 1000
                 classes), bf16, seeded weights with the AdaLN modulations
                 drawn off zero; gates: (a) one forward at B 16 (8 labels
                 + 8 null), the kernel path's relative L2 error against
                 a float32 copy within 1.2x the plain path's; (b)
                 ``ddim_sample`` of 8 labels, 50 steps, guidance 4, eta
                 0: the key built once (one denoising step captured as a
                 CUDA graph, replayed 50 times a sample), K2 28 x 50
                 launches, no plain route, finite latents equal bit for
                 bit to the eager twin's; (c) the tiny float32 DiT and a
                 narrow one at head_dim 72, 8 guided steps on the card
                 against the CPU (``dit_tiny_f32`` lines).  Sampling ms,
                 latents/s, ms a step, K2's share, peak memory; with
                 ``--profile`` the eager twin's kernel time a step by
                 class (K2, GEMM, other); ``dit_c2`` (ROADMAP C2): the
                 weights converted to float32 and back (new storage),
                 a copy made after, the sampler's latents equal to the
                 copy's and to the first sample's;
  dit_train.   — DiT-XL/2 as in ``dit``, not cut, trained by
                 ``build_train_step`` with the DiT paper's AdamW (lr 1e-4,
                 betas (0.9, 0.999), weight decay 0) on 32 seeded latents a
                 step (t uniform, x_t from the DDPM schedule, target the
                 noise, 10 % null labels); gates: (a) step-1 gradients of
                 8 latents, the kernel path within 1.2x the plain path's
                 error against a float32 copy (``dit_train_grads``); (b)
                 8 steps: every loss finite, K2 = K5 = K6 = 28 launches a
                 step and no other kernel, no plain route, K5 / K6 calls
                 of a step the same bits when launched again, and with
                 ``recompute=True`` K2 2 x 28 for a micro-batch's
                 gradients; (c) the tiny float32 DiT and the narrow one
                 at head_dim 72, 4 train steps on the card against the CPU
                 (``dit_train_tiny_f32`` lines).  Step ms p50 (steps 3-8),
                 latents/s, tokens/s, model-FLOPs share of 989 TFLOP/s,
                 peak memory, K5 + K6's share of a step; with
                 ``--profile`` one step's kernel time by class, the
                 optimizer's device time and the device's busy share;
  qwen2_vl.    — ``Qwen2VLConfig()`` (224 x 224 images in 256 patches,
                 a 2-block tower of 4 heads of 64, a 4-layer decoder of 8
                 heads of 128 with a cross layer after every 2nd), bf16,
                 cross gates at 0.5; gates: forward logits of 4 images and
                 64-token prompts, and greedy generation's first decode
                 step's (K1 at Hq = Hkv), within 1.2x the plain path's
                 error against a float32 copy; greedy and beam-4
                 ``generate`` of 32 new tokens graphed beside the eager
                 twin, bit for bit, with K2 70 launches (by shape, counted
                 where K2 launches, in the graphed runs and the twin: D 64
                 2, causal D 128 4, cross D 128 at Sq 64 2 and at Sq 1 62),
                 K1 124, K3 352; C2 for the generation graph (a dtype
                 round trip, tokens equal to a fresh copy's); the tiny
                 float32 model, greedy and beam, card tokens equal to the
                 CPU's (``qwen2_vl_tiny_f32``);
  qwen2_vl_train. — the same model, ``build_train_step`` with AdamW (lr
                 1e-4, weight decay 0.01), 4 steps of 4 images: step-1
                 gradients within 1.2x the plain path's error against a
                 float32 copy (``qwen2_vl_train_grads``); K2 = K5 = K6 = 8
                 a step (by shape: D 64 2, causal D 128 4, cross D 128 2),
                 K3 11, no plain route, K5 / K6 the same bits again; the
                 tiny float32 model 4 steps card against CPU
                 (``qwen2_vl_train_tiny_f32``);
  5. training  — Llama-3-8B width cut
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
and K4 from phase 4c, of K1-int8 from phase 4d, of K2-paged and
K2-paged-int8 over the identity view from phases 4e and 4g, of K5 and K6
from phase 5, of K2 at head_dim 72 from the dit phase, of K5 and K6 at
head_dim 72 from dit_train, of K2 at head_dim 64 and of the cross K2 from
qwen2_vl's greedy run, of K5 and K6 at head_dim 64 from qwen2_vl_train;
error and times from phase 2) and, last,
``{"ok": true,
"device": {...}}``.

``--profile`` adds the device time of K1, K1-int8, K1-paged and
K1-paged-int8 by split length (K1 and K1-int8 at phase 2's main and
all-at-4095 rows, the paged builds at the main, block_len 8 and
all-at-4095 rows), a torch.profiler window (with CUDA events around it)
over 5 decode ticks of the contiguous, int8 contiguous, paged and int8
paged engines, of the chunked engine and of the speculative contiguous,
paged and int8 paged engines (verify ticks), each graphed and then eager
(``mode``), and over one
dit_train and one phase-5 train step (kernel time by name and class, the
optimizer's device time, device busy share) for PERF.md.
"""

from __future__ import annotations

import argparse
import contextlib
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
    # K2-paged(-int8) over the contiguous cache's identity view: the
    # chunked engine's prompt chunk, the q-tiled contiguous mode of the
    # reference's flash-decode kernel (:273-281, :303-311)
    "flash_attention_fwd_paged/identity": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    "flash_attention_fwd_paged_int8/identity": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:120"},
    # K2 at head_dim 72: the DiT-XL/2 blocks' attention (the dit phase)
    "flash_attention_fwd/d72": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:128"},
    # K5 / K6 at head_dim 72: the DiT-XL/2 blocks' backward (dit_train)
    "flash_attention_bwd_dq/d72": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:252"},
    "flash_attention_bwd_dkv/d72": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:299"},
    # K2 at head_dim 64, not causal: Qwen2-VL's vision tower (qwen2_vl)
    "flash_attention_fwd/d64": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:128"},
    # K2 not causal at head_dim 128 with Sq != Skv: Qwen2-VL's
    # cross-attention, text queries over the patches (Sq 1 a decode step)
    "flash_attention_fwd/cross": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:128"},
    # K5 / K6 at head_dim 64: the vision tower's backward (qwen2_vl_train)
    "flash_attention_bwd_dq/d64": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:252"},
    "flash_attention_bwd_dkv/d64": {
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
# gate (a) for a one-element parameter (Qwen2-VL's cross gates): its
# gradient is ONE sum over every element of the layer's output (4 x 64 x
# 1024 terms in qwen2_vl_train) whose terms cancel with random weights
# (|sum| / sum(|term|) 0.0007-0.0057), so any path's rounding is
# magnified 200-1400x and no ratio between two paths holds: over 8 seeds
# (chip_cross_gate_grads.py on an H100 80GB HBM3, 700 W) the kernel path
# was 0.39-7.3x the plain path's error, and two plain paths that differ
# only in rounding P to bf16 0.05-7.9x each other, while the summed gate
# stayed at 1.01-1.04x.  The 48 readings (2 gates x 3 paths x 8 seeds)
# lay in 0.00025-0.106 (kernel at most 0.073); such a tensor is held at
# twice the largest, 0.2 relative: a wrong kernel moves it by O(1)
GRAD_SCALAR_TOL = 0.2
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
    ``-v`` report (mangled names; the Hopper K2 kernel's template
    arguments are <SEG, PAGED, INT8>, so ``ILb0ELb1ELb1EE`` is
    K2-paged-int8)."""
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
    k1_mma = mma_decode_builds(ptxas)
    emit({"phase": "card", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc_build_s": round(build_s, 3),
          "ptxas_logs": sorted(pt_build.build_log),
          "wgmma_serialized": serialized, "k1_mma": k1_mma,
          "ptxas": ptxas})
    check(not serialized, f"ptxas serialised wgmma in {serialized}")
    check(all(r.get("spill_stores", 0) == 0 and r["ctas_per_sm"] >= 1
              for r in k1_mma.values()),
          f"a Hopper K1 build spills or does not fit: {k1_mma}")
    return card


# the Hopper K1 kernel's builds: (name, int8, paged)
K1_MMA_BUILDS = (("decode_attention", 0, 0), ("decode_attention_int8", 1, 0),
                 ("decode_attention_paged", 0, 1),
                 ("decode_attention_paged_int8", 1, 1))


def mma_decode_builds(ptxas):
    """Each build of the Hopper K1 kernel (``decode_mma_kernel<INT8,
    PAGED>``): ptxas's registers and spill bytes (when this process built
    the library) and the CTAs that fit on one SM (minus a CUDA error)."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    lib = da._lib()
    fns = ptxas.get("decode_attention", {}).get("functions", {})
    out = {}
    for name, int8, paged in K1_MMA_BUILDS:
        tag = f"decode_mma_kernelILb{int8}ELb{paged}E"
        row = next((dict(r) for f, r in fns.items() if tag in f), {})
        row["ctas_per_sm"] = lib.decode_attention_mma_ctas_per_sm(int8, paged)
        out[name] = row
    return out


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


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def backward_sets(torch, randn, dt, b, sq, skv, hq, hkv, d, kw):
    """Input copies of a K5 / K6 row, cycled past L2 (:func:`copies`):
    (q, k, v, dO, dlse, out, lse, delta), out and lse from K2 and delta =
    rowsum(dO * out) - dlse."""
    from paddle_tpu_torch.ops import flash_attention_fwd_cuda
    esz = 2 if dt == torch.bfloat16 else 4
    sets = []
    for _ in range(copies(b * (2 * sq * hq + 2 * skv * hkv) * d * esz)):
        q, k, v, do = (randn(b, sq, hq, d, dtype=dt),
                       randn(b, skv, hkv, d, dtype=dt),
                       randn(b, skv, hkv, d, dtype=dt),
                       randn(b, sq, hq, d, dtype=dt))
        dlse = randn(b, hq, sq, dtype=torch.float32)
        out, lse = flash_attention_fwd_cuda(q, k, v, **kw)
        delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
                 - dlse).contiguous()
        sets.append((q, k, v, do, dlse, out, lse, delta))
    return sets


def backward_rows(torch, record, tols, sets, kw, keep, tag, extra, lib_mask,
                  main, names=TRAIN_KERNELS):
    """K5 (``names[0]``) and K6 (``names[1]``) on :func:`backward_sets`
    against ``flash_attention_bwd_reference`` on the same out / lse, and
    against themselves (no atomics: a second launch gives the same bits),
    the dead-row convention on ``keep`` (zero dq for a query that sees no
    key, zero dk / dv for a key no query sees); one phase-2 row each with
    the plain, library (SDPA's backward alone) and bound times.  Returns
    the library ms."""
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_reference)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    import torch.nn.functional as TF

    q, k, v, do, dlse, out, lse, delta = sets[0]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dt = q.dtype
    esz = 2 if dt == torch.bfloat16 else 4
    seg, kv_seg = kw["segment_ids"], kw["kv_segment_ids"]
    pairs = int(keep.expand(b, sq, skv).sum().item())
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    same = {names[0]: torch.equal(
                dq, flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                **kw)),
            names[1]: all(map(torch.equal, (dk, dv), (
                flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                             **kw))))}
    rq, rk, rv = flash_attention_bwd_reference(q, k, v, out, lse, do, dlse,
                                               **kw)
    torch.cuda.synchronize()
    with reference_mode():
        plain_ms = time_ms(torch, [
            lambda t=t: flash_attention_bwd_reference(
                t[0], t[1], t[2], t[5], t[6], t[3], t[4], **kw)
            for t in sets], budget_ms=100.0)
    # SDPA's backward alone: one untimed forward a set, then the backward
    # is timed on the retained graph
    graphs = []
    for t in sets:
        leaves = tuple(x.transpose(1, 2).detach().clone()
                       .requires_grad_(True) for x in t[:3])
        o = TF.scaled_dot_product_attention(
            *leaves, attn_mask=lib_mask,
            is_causal=kw["causal"] and lib_mask is None, enable_gqa=True)
        graphs.append((o, leaves, t[3].transpose(1, 2)))
    lfns = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2],
                                            retain_graph=True)
            for g in graphs]
    lib_ms = time_ms(torch, lfns)
    bwd_extra = dict(extra, visible_pairs=pairs,
                     library_kernel=top_kernel(torch, lfns[0]))
    del graphs, lfns
    io = 4 * b * hq * sq * 2 + (0 if seg is None else 4 * b * sq) \
        + (0 if kv_seg is None else 4 * b * skv)
    # keys no query sees get zero dk and dv, as dead rows get zero dq
    dead_keys = (~keep.any(1)).expand(b, skv)
    for name, got, want, flops_per_pair, out_elems in (
            (names[0], (dq,), (rq,), 6, b * sq * hq * d),
            (names[1], (dk, dv), (rk, rv), 8, 2 * b * skv * hkv * d)):
        err = max(max_err(g, w) for g, w in zip(got, want))
        rels = [rel_l2(g, w) for g, w in zip(got, want)]
        if dt == torch.bfloat16:
            tol = f"relative L2 per tensor <= {BWD_REL_TOL_BF16}"
            ok = max(rels) <= BWD_REL_TOL_BF16
        else:
            atol, rtol = tols(dt)
            tol = f"atol {atol} + rtol {rtol}"
            ok = all(within(g, w, atol, rtol) for g, w in zip(got, want))
        ok = (ok and same[name]
              and all(bool(torch.isfinite(g).all().item()) for g in got))
        if name == names[0]:
            ok = ok and dead_rows_ok(torch, keep, b, grad=dq)
        else:
            ok = ok and all(bool((g[dead_keys] == 0).all().item())
                            for g in got)
        fn = (flash_attention_bwd_dq_cuda if name == names[0]
              else flash_attention_bwd_dkv_cuda)
        kfns = [lambda t=t, fn=fn: fn(t[0], t[1], t[2], t[3], t[6], t[7],
                                      **kw) for t in sets]
        nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d
                  + out_elems) * esz + io
        bms, by = bound(nbytes, flops_per_pair * d * hq * pairs,
                        BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        record(name, tag, err, tol + ", finite, dead rows (keys) 0, "
               "the same bits twice", ok,
               kfns, plain_ms, lib_ms, bms, by, main,
               note=BWD_LIBRARY_NOTE + (
                   "; " + SEGMENTED_LIBRARY_NOTE if lib_mask is not None
                   else ""),
               extra=dict(bwd_extra, rel_l2=rels, head_dim=d,
                          deterministic=same[name],
                          plain_note="flash_attention_bwd_reference: dq, "
                                     "dk and dv together"))
    return lib_ms


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
        return row

    # ---- K1 flash-decode: the decode tick's shape (bf16, head_dim 128),
    # every row at the last position (every split live: the merge's
    # deepest case) and a 4-token window (two 8-row tiles), then the tiny
    # model's float32 build (head_dim 16); Qwen2-VL's decoder (one query
    # head a KV head: Hq = Hkv = 8) at its generation cache of 96, greedy
    # B 4 and beam-4 B 16, positions spread over the prefix.  The bf16
    # rows check the same bits on two calls (the splits are merged in
    # split order) --------------------------------------------------------
    for dt, hq, hkv, d, b, s, L, pos_list, main in (
            (bf16, 32, 8, 128, 8, 1, 4096,
             [0, 4095, 17, 1000, 2047, 3000, 511, 128], True),
            (bf16, 32, 8, 128, 8, 1, 4096, [4095] * 8, False),
            (bf16, 32, 8, 128, 2, 4, 1024, [0, 700], False),
            (bf16, 8, 8, 128, QWEN_BATCH, 1, QWEN_PROMPT + QWEN_NEW,
             [0, 31, QWEN_PROMPT, QWEN_PROMPT + QWEN_NEW - 1], False),
            (bf16, 8, 8, 128, 4 * QWEN_BATCH, 1, QWEN_PROMPT + QWEN_NEW,
             [6 * i + 5 for i in range(4 * QWEN_BATCH)], False),
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
        extra = {}
        if dt == bf16:
            extra["deterministic"] = bool(torch.equal(
                got, cached_decode_attention(q, kc, vc, pos)))
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and extra.get("deterministic",
                                                         True)
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
               err, f"atol {atol} + rtol {rtol}"
               + (", the same bits twice" if dt == bf16 else ""), ok, kfns,
               plain_ms, lib_ms, bms, by, main, extra=extra)
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
    from paddle_tpu_torch.ops import flash_attention_fwd_cuda

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
        kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
        sets = backward_sets(torch, randn, dt, b, sq, skv, hq, hkv, d, kw)
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

        lib_ms = backward_rows(torch, record, tols, sets, kw, keep, tag,
                               seg_extra, lib_mask, main)
        if seg is None and causal and dt == bf16 and sq == TRAIN_SEQ:
            for name in TRAIN_KERNELS:
                results[name]["library_ms_unsegmented"] = lib_ms
        del sets, q, k, v, do, dlse, out, lse, delta

    # ---- K1-paged / K2-paged: the paged engine's decode tick (s = 1) and
    # suffix prefill (s > 1) over a pool of block_len-token blocks, bf16 at
    # head_dim 128 (block_len 128, max_blocks 32: max_length 4096; K2-paged
    # also at block_len 64), then the tiny model's float32 builds (head_dim
    # 16).  Every pool has its physical blocks shuffled, two row pairs
    # sharing their first blocks and null-filled dead tails; rows whose
    # pos + s passes max_blocks * block_len check the clamp.
    paged_rows = (
        # K1-paged: K1's phase-2 depths, so the two rows compare
        ("decode_attention_paged", bf16, 32, 8, 128, 8, 1, 128, 32,
         [0, 4095, 17, 1000, 2047, 3000, 511, 128], ((1, 4, 16), (5, 3, 8)),
         True),
        ("decode_attention_paged", bf16, 32, 8, 128, 2, 1, 16, 64,
         [33, 1000], ((0, 1, 2),), False),
        # block_len 8: a 16-key slice spans two blocks (two table entries,
        # int8: two scale pairs); depths on and beside the 8-key group, the
        # 256-key split and the 4096-key end
        ("decode_attention_paged", bf16, 32, 8, 128, 7, 1, 8, 512,
         [0, 7, 8, 255, 256, 257, 4095], ((5, 6, 32),), False),
        # every row at the last position: every split of every row live
        ("decode_attention_paged", bf16, 32, 8, 128, 8, 1, 128, 32,
         [4095] * 8, ((0, 1, 16), (2, 3, 8)), False),
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
        # three q tiles, the last ragged, at the main widths (G = 4)
        ("flash_attention_fwd_paged", bf16, 32, 8, 128, 2, 300, 128, 32,
         [0, 1536], ((0, 1, 4),), False),
        # block_len 64: a 128-key tile spans two blocks (two table entries,
        # int8: two scale pairs); an odd max_blocks leaves a tile's second
        # half past the table, and row 2's pos + s passes it
        ("flash_attention_fwd_paged", bf16, 32, 8, 128, 3, 300, 64, 23,
         [0, 200, 1300], ((0, 1, 3),), False),
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
        extra = {}
        if s == 1:   # K1-paged: the same bits twice (splits merged in order)
            extra["deterministic"] = bool(torch.equal(
                got, cached_decode_attention(q, kp, vp, pos,
                                             block_tables=tables)))
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and bool(
            torch.isfinite(got).all().item()) and extra.get(
                "deterministic", True)
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
               bms, by, main, note=PAGED_LIBRARY_NOTE, extra=extra)
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
    # granules), every row at 4095, 8-token granules (a 16-key slice spans
    # two: two scale pairs; depths on and beside the 8-key group, the
    # 256-key split and the 4096-key end) and the 4-token window, then the
    # tiny model's one-granule float32 cache.  The bf16 rows check the
    # same bits on two calls
    for dt, hq, hkv, d, b, s, L, n_gran, pos_list, main in (
            (bf16, 32, 8, 128, 8, 1, 4096, 32,
             [0, 4095, 17, 1000, 2047, 3000, 511, 128], True),
            (bf16, 32, 8, 128, 8, 1, 4096, 32, [4095] * 8, False),
            (bf16, 32, 8, 128, 7, 1, 4096, 512,
             [0, 7, 8, 255, 256, 257, 4095], False),
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
        extra = {}
        if dt == bf16:
            extra["deterministic"] = bool(torch.equal(got, run(sets[0])))
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and extra.get("deterministic",
                                                         True)
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
               err, f"atol {atol} + rtol {rtol}"
               + (", the same bits twice" if dt == bf16 else ""), ok, kfns,
               plain_ms, lib_ms, bms, by, main, note=INT8_LIBRARY_NOTE,
               extra=extra)
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
        extra = {}
        if s == 1:   # K1-paged-int8: the same bits twice
            extra["deterministic"] = bool(torch.equal(got, run(sets[0])))
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and bool(
            torch.isfinite(got).all().item()) and extra.get(
                "deterministic", True)
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
               bms, by, main, note=INT8_LIBRARY_NOTE, extra=extra)
        del sets, got, want

    phase_identity_rows(torch, record, randn, int8_payload, int8_scales,
                        tols)
    phase_verify_window_rows(torch, record, randn, int8_payload,
                             int8_scales, tols, paged_rows[0][10])
    phase_head_dim_rows(torch, record, randn, tols)

    # K4 weight-only int8 GEMM: a decode tick's 8 rows at every Llama-3-8B
    # projection shape (K, N), the row counts of short prefill waves at
    # gate/up, 256 rows (the kernel's row limit), the speculative verify
    # tick's 40 rows at gate/up and the LM head, then the tiny model's
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
            # the speculative verify tick: 8 rows x (k + 1) = 40
            (bf16, 40, 4096, 14336, False),
            (bf16, 40, 4096, 128256, False),
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


# DiT-XL/2 (the dit phase): hidden 1152 / 16 heads, 32 x 32 latents in 2 x 2
# patches; 8 labels and their 8 null rows (classifier-free guidance)
DIT_DEPTH, DIT_HEADS, DIT_HEAD_DIM, DIT_TOKENS = 28, 16, 72, 256
DIT_LABELS, DIT_STEPS, DIT_CFG = 8, 50, 4.0
DIT_BATCH = 2 * DIT_LABELS
# dit_train: the DiT paper's AdamW (lr 1e-4, betas (0.9, 0.999), no weight
# decay) on 32 latents a step (its global batch of 256 over 8 cards), 10 %
# of the labels the null class (its label dropout, applied as data); 8
# steps, the first 2 untimed; gate (a) on a micro-batch of 8
DIT_TRAIN_BATCH, DIT_TRAIN_STEPS, DIT_TRAIN_UNTIMED = 32, 8, 2
DIT_GRAD_BATCH, DIT_TRAIN_LR, DIT_LABEL_DROP = 8, 1e-4, 0.1
DIT_BWD = ("flash_attention_bwd_dq/d72", "flash_attention_bwd_dkv/d72")
# Qwen2-VL at its default widths (qwen2_vl, qwen2_vl_train): 4 images of
# 224 x 224 in 14 x 14 patches (256), the tower 2 blocks of 4 heads of 64,
# the decoder 4 layers of 8 heads of 128, a cross layer after every 2nd
QWEN_BATCH, QWEN_PATCHES, QWEN_VISION_HEADS = 4, 256, 4
QWEN_HEADS, QWEN_PROMPT, QWEN_NEW = 8, 64, 32
QWEN_BWD = ("flash_attention_bwd_dq/d64", "flash_attention_bwd_dkv/d64")


def phase_head_dim_rows(torch, record, randn, tols):
    """Phase 2's rows of K2 at the head dims below 128 (the contiguous
    build takes any D <= 128 with D % 8 == 0 on zero-padded 128-wide
    tiles; float32 its CUDA-core instances at 64 and 72): bf16 D 72 at
    the dit phase's shape (B 16, S 256, 16 heads, full attention; the
    ``flash_attention_fwd/d72`` entry's main row), causal GQA at a ragged
    Sq 77 over Skv 61 (queries 0..15 see no key: out 0, lse -1e30), the
    ring-hop segmented form (separate kv ids, queries whose id matches no
    key), bf16 D 64 (the second TMA box wholly past the tensor), then
    float32 at 72 (the narrow DiT's shape and a ragged causal one) and
    64.  Each holds out, lse and the dead rows against the plain
    version.  Then K5 / K6 at the same head dims
    (:func:`backward_rows`): bf16 D 72 at the dit_train step's shape (B 32,
    S 256, 16 heads, full attention; the ``flash_attention_bwd_*/d72``
    entries' main rows), and at D 72 and 64 the contract rows -- causal
    GQA at Sq 77 over Skv 61 (dead rows), the ring-hop segmented form (Sq
    256, Skv 512, queries whose id matches no key) and packed documents
    at an unaligned S 300 -- then float32 at 72 (the narrow DiT's shape,
    Sq 77 / Skv 61) and 64."""
    from paddle_tpu_torch.ops import (flash_attention,
                                      flash_attention_fwd_cuda)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    for (name, dt, b, sq, skv, hq, hkv, d, causal, ring, main) in (
            ("flash_attention_fwd/d72", bf16, DIT_BATCH, DIT_TOKENS,
             DIT_TOKENS, DIT_HEADS, DIT_HEADS, DIT_HEAD_DIM, False, False,
             True),
            ("flash_attention_fwd/d72", bf16, 2, 77, 61, 8, 2, 72, True,
             False, False),
            ("flash_attention_fwd/d72", bf16, 2, 256, 512, 8, 2, 72, True,
             True, False),
            ("flash_attention_fwd", bf16, 4, 512, 512, 8, 8, 64, False,
             False, False),
            ("flash_attention_fwd", bf16, 2, 77, 61, 8, 2, 64, True, False,
             False),
            ("flash_attention_fwd/d72", f32, 4, 16, 16, 2, 2, 72, False,
             False, False),
            ("flash_attention_fwd/d72", f32, 2, 77, 61, 4, 2, 72, True,
             False, False),
            ("flash_attention_fwd", f32, 2, 70, 70, 4, 2, 64, False, False,
             False),
            ("flash_attention_fwd/d64", bf16, QWEN_BATCH, QWEN_PATCHES,
             QWEN_PATCHES, QWEN_VISION_HEADS, QWEN_VISION_HEADS, 64, False,
             False, True),
            ("flash_attention_fwd/cross", bf16, QWEN_BATCH, 1, QWEN_PATCHES,
             QWEN_HEADS, QWEN_HEADS, 128, False, False, True),
            ("flash_attention_fwd/cross", bf16, QWEN_BATCH, QWEN_PROMPT,
             QWEN_PATCHES, QWEN_HEADS, QWEN_HEADS, 128, False, False,
             False)):
        atol, rtol = tols(dt)
        lse_tol = 1e-3 if dt == bf16 else 1e-5
        esz = 2 if dt == bf16 else 4
        seg = kv_seg = None
        if ring:
            ids_kv = packed_segments(b, skv, seed=skv)
            ids_q = (packed_segments(b, sq, seed=sq, lo=3, hi=6)
                     + ids_kv.max(1, keepdims=True) - 1)
            seg = torch.from_numpy(ids_q).to(dev)
            kv_seg = torch.from_numpy(ids_kv).to(dev)
        kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
        keep = visible_pairs(torch, sq, skv, causal, seg, kv_seg, dev)
        pairs = int(keep.expand(b, sq, skv).sum().item())
        n_dead = int((~keep.any(-1)).expand(b, sq).sum().item())
        nb = b * (2 * sq * hq + 2 * skv * hkv) * d * esz
        sets = [(randn(b, sq, hq, d, dtype=dt), randn(b, skv, hkv, d, dtype=dt),
                 randn(b, skv, hkv, d, dtype=dt)) for _ in range(copies(nb))]
        q, k, v = sets[0]
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        with reference_mode():
            ref, ref_lse = flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        err, lerr = max_err(out, ref), max_err(lse, ref_lse)
        ok = (within(out, ref, atol, rtol) and lerr <= lse_tol
              and dead_rows_ok(torch, keep, b, out, lse)
              and (n_dead > 0) == (ring or (causal and sq > skv)))
        kfns = [lambda t=t: flash_attention_fwd_cuda(*t, **kw) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: flash_attention(*t, **kw) for t in sets],
                budget_ms=100.0)
        mask = (None if seg is None and (sq == skv or not causal)
                else keep[:, None])
        lfns = [lambda t=t: TF.scaled_dot_product_attention(
            t[0].transpose(1, 2), t[1].transpose(1, 2), t[2].transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True) for t in sets]
        lib_ms = time_ms(torch, lfns)
        nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * esz \
            + 4 * b * hq * sq + (0 if seg is None else 4 * b * (sq + skv))
        bms, by = bound(nbytes, 4 * d * hq * pairs,
                        BF16_FLOPS if dt == bf16 else F32_FLOPS)
        tag = (f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} "
               f"{'causal' if causal else 'causal=False'} "
               f"{'ring-hop kv_segment_ids ' if ring else ''}{str(dt)[6:]}")
        record(name, tag, max(err, lerr),
               f"out atol {atol} + rtol {rtol}, lse {lse_tol}, dead rows "
               f"out 0 and lse -1e30", ok, kfns, plain_ms, lib_ms, bms, by,
               main, note=SEGMENTED_LIBRARY_NOTE if mask is not None else None,
               extra={"head_dim": d, "visible_pairs": pairs,
                      "dead_rows": n_dead,
                      "library_kernel": top_kernel(torch, lfns[0])})
        del sets, q, k, v, out, lse, ref, ref_lse

    for (names, dt, b, sq, skv, hq, hkv, d, causal, segments, main) in (
            (DIT_BWD, bf16, DIT_TRAIN_BATCH, DIT_TOKENS, DIT_TOKENS,
             DIT_HEADS, DIT_HEADS, DIT_HEAD_DIM, False, None, True),
            (DIT_BWD, bf16, 2, 77, 61, 8, 2, 72, True, None, False),
            (DIT_BWD, bf16, 2, 256, 512, 8, 2, 72, True, "ring", False),
            (DIT_BWD, bf16, 2, 300, 300, 8, 2, 72, True, "packed", False),
            (TRAIN_KERNELS, bf16, 2, 77, 61, 8, 2, 64, True, None, False),
            (TRAIN_KERNELS, bf16, 2, 256, 512, 8, 2, 64, True, "ring",
             False),
            (TRAIN_KERNELS, bf16, 2, 300, 300, 8, 2, 64, True, "packed",
             False),
            (DIT_BWD, f32, 4, 16, 16, 2, 2, 72, False, None, False),
            (DIT_BWD, f32, 2, 77, 61, 4, 2, 72, True, None, False),
            (TRAIN_KERNELS, f32, 2, 70, 70, 4, 2, 64, False, None, False),
            (TRAIN_KERNELS, f32, 2, 77, 77, 4, 2, 64, True, "packed",
             False),
            (QWEN_BWD, bf16, QWEN_BATCH, QWEN_PATCHES, QWEN_PATCHES,
             QWEN_VISION_HEADS, QWEN_VISION_HEADS, 64, False, None, True),
            (TRAIN_KERNELS, bf16, QWEN_BATCH, QWEN_PROMPT, QWEN_PATCHES,
             QWEN_HEADS, QWEN_HEADS, 128, False, None, False)):
        seg = kv_seg = None
        if segments == "packed":
            seg = torch.from_numpy(packed_segments(b, sq, seed=sq)).to(dev)
        elif segments == "ring":
            ids_kv = packed_segments(b, skv, seed=skv)
            ids_q = (packed_segments(b, sq, seed=sq, lo=3, hi=6)
                     + ids_kv.max(1, keepdims=True) - 1)
            seg = torch.from_numpy(ids_q).to(dev)
            kv_seg = torch.from_numpy(ids_kv).to(dev)
        kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
        keep = visible_pairs(torch, sq, skv, causal, seg,
                             seg if kv_seg is None else kv_seg, dev)
        n_dead = int((~keep.any(-1)).expand(b, sq).sum().item())
        check((n_dead > 0) == (segments == "ring" or (causal and sq > skv)),
              f"K5 / K6 D {d} Sq {sq} Skv {skv}: {n_dead} dead rows")
        sets = backward_sets(torch, randn, dt, b, sq, skv, hq, hkv, d, kw)
        shape = (f"S={sq}" if sq == skv and segments != "ring"
                 else f"Sq={sq} Skv={skv}")
        tag = (f"B={b} {shape} Hq={hq} Hkv={hkv} D={d} "
               f"{'causal' if causal else 'causal=False'} "
               f"{'packed ' if segments == 'packed' else ''}"
               f"{'ring-hop kv_segment_ids ' if segments == 'ring' else ''}"
               f"{str(dt)[6:]}")
        lib_mask = (None if seg is None and (sq == skv or not causal)
                    else keep[:, None])
        backward_rows(torch, record, tols, sets, kw, keep, tag,
                      {"segmented": seg is not None, "dead_rows": n_dead},
                      lib_mask, main, names)
        del sets


def phase_verify_window_rows(torch, record, randn, int8_payload, int8_scales,
                             tols, share):
    """Phase 2's rows at the speculative verify window's shape: 8 rows of
    s = SPEC_K + 1 = 5 queries at phase 2's main depths (a window at 4095
    runs past the 4096-key cache: its pad columns), bf16, head_dim 128.
    Contiguous: K1 and K1-int8 (128-token granules), the engine's route.
    Paged (block_len 128, max_blocks 32, K1-paged's shuffled pool with
    shared first blocks): K2-paged and K2-paged-int8, the engine's route
    for s > 1, and beside them K1-paged and K1-paged-int8 at the same
    window, called directly (the route does not send s > 1 there).  Each
    against the plain version, with SDPA's time over the (pre-gathered,
    dequantized) cache and the bound; the ``verify_window`` line puts the
    paged kernels side by side."""
    from paddle_tpu_torch.ops import (cached_decode_attention_reference,
                                      decode_attention_cuda,
                                      decode_attention_int8_cuda,
                                      decode_attention_paged_cuda,
                                      decode_attention_paged_int8_cuda,
                                      flash_attention_fwd_paged_cuda,
                                      flash_attention_fwd_paged_int8_cuda)
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    b, s, hq, hkv, d, L, gr, bl, mb = 8, SPEC_K + 1, 32, 8, 128, 4096, 128, \
        128, 32
    pos_list = [0, 4095, 17, 1000, 2047, 3000, 511, 128]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    atol, rtol = tols(bf16)
    kj = torch.arange(L, device=dev)
    qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
    mask = (kj[None, None] <= qi[:, :, None])[:, None]          # B,1,s,L
    ops = sum(4 * d * hq * min(p + si + 1, L)
              for p in pos_list for si in range(s))
    live = sum(min(L, p + s) for p in pos_list)
    tables, n_blocks, live_keys = paged_layout(pos_list, s, bl, mb, share,
                                               seed=len(pos_list))
    live_blocks = len({int(tables[r, j // bl])
                       for r, p in enumerate(pos_list)
                       for j in range(0, min(p + s, L), bl)})
    tables = torch.from_numpy(tables).to(dev)
    idx = tables.long()

    def deq(pay, sc, paged):
        if paged:
            return (pay[idx].float() * sc[idx][:, :, None, :, None]).reshape(
                b, L, hkv, d).to(bf16)
        return (pay.float().view(b, L // gr, gr, hkv, d)
                * sc[:, :, None, :, None]).view(b, L, hkv, d).to(bf16)

    side = {}
    for name, paged, int8, fn in (
            ("decode_attention", False, False, decode_attention_cuda),
            ("decode_attention_int8", False, True,
             decode_attention_int8_cuda),
            ("flash_attention_fwd_paged", True, False,
             flash_attention_fwd_paged_cuda),
            ("decode_attention_paged", True, False,
             decode_attention_paged_cuda),
            ("flash_attention_fwd_paged_int8", True, True,
             flash_attention_fwd_paged_int8_cuda),
            ("decode_attention_paged_int8", True, True,
             decode_attention_paged_int8_cuda)):
        rows = n_blocks if paged else b
        width = bl if paged else L
        esz = 1 if int8 else 2
        sets = []
        for _ in range(copies(2 * rows * width * hkv * d * esz)):
            q = randn(b, s, hq, d)
            if int8:
                shp = (rows, hkv) if paged else (b, L // gr, hkv)
                sets.append((q, int8_payload(rows, width, hkv, d),
                             int8_payload(rows, width, hkv, d),
                             int8_scales(*shp), int8_scales(*shp)))
            else:
                sets.append((q, randn(rows, width, hkv, d),
                             randn(rows, width, hkv, d)))
        kw = dict(block_tables=tables) if paged else {}

        def call(t, f=fn, kw=kw, int8=int8):
            sc = dict(k_scale=t[3], v_scale=t[4]) if int8 else {}
            return f(t[0], t[1], t[2], pos=pos, **kw, **sc)

        def plain(t, kw=kw, int8=int8):
            sc = dict(k_scale=t[3], v_scale=t[4]) if int8 else {}
            return cached_decode_attention_reference(t[0], t[1], t[2], pos,
                                                     **kw, **sc)
        got, want = call(sets[0]), plain(sets[0])
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and bool(
            torch.isfinite(got).all().item())
        kfns = [lambda t=t: call(t) for t in sets]
        plain_ms = time_ms(torch, [lambda t=t: plain(t) for t in sets],
                           budget_ms=100.0)
        dense = []
        for t in sets[:2]:
            if int8:
                dense.append((t[0], deq(t[1], t[3], paged),
                              deq(t[2], t[4], paged)))
            elif paged:
                dense.append((t[0], t[1][idx].reshape(b, L, hkv, d),
                              t[2][idx].reshape(b, L, hkv, d)))
            else:
                dense.append(t[:3])
        lib_ms = time_ms(torch, [
            lambda t=t: TF.scaled_dot_product_attention(
                t[0].transpose(1, 2), t[1].transpose(1, 2),
                t[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
            for t in dense])
        del dense
        nbytes = 2 * b * s * hq * d * 2 + (live_keys if paged else live) \
            * hkv * d * esz * 2 + 4 * b * ((mb + 1) if paged else 1)
        if int8:
            nbytes += (live_blocks if paged else sum(
                -(-min(L, p + s) // gr) for p in pos_list)) * hkv * 4 * 2
        bms, by = bound(nbytes, ops, BF16_FLOPS)
        route = ("the engine's route" if name.startswith("flash") or not paged
                 else "called directly: the route sends s > 1 to K2-paged")
        row = record(name,
                     f"verify window: B={b} s={s} Hq={hq} Hkv={hkv} D={d} "
                     + (f"block_len={bl} max_blocks={mb} pool={n_blocks} "
                        if paged else f"L={L} ")
                     + f"pos={pos_list}"
                     + (f" int8 K/V{'' if paged else f' granule {gr}'}, "
                        f"bfloat16 q" if int8 else " bfloat16"),
                     err, f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms,
                     lib_ms, bms, by, False,
                     note=INT8_LIBRARY_NOTE if int8 else (
                         PAGED_LIBRARY_NOTE if paged else None),
                     extra={"verify_window": True, "route": route})
        side[name] = {k: row[k] for k in ("kernel_ms", "device_ms",
                                          "library_ms", "bound_ms")}
        del sets, got, want
    emit({"phase": "verify_window", "s": s, "rows": side,
          "k1_paged_over_k2_paged": round(
              side["decode_attention_paged"]["kernel_ms"]
              / side["flash_attention_fwd_paged"]["kernel_ms"], 3),
          "k1_paged_int8_over_k2_paged_int8": round(
              side["decode_attention_paged_int8"]["kernel_ms"]
              / side["flash_attention_fwd_paged_int8"]["kernel_ms"], 3)})


def phase_identity_rows(torch, record, randn, int8_payload, int8_scales,
                        tols):
    """Phase 2's rows of the contiguous cache through its identity view
    (``ops.attention.identity_view``, the chunked engine's prompt chunk):
    K2-paged and K2-paged-int8 over an 8-row, 4096-position bf16 cache
    (int8: 128-token scale granules), one 256-query chunk into row 5 at
    pos 0, 1024 and 3840 (``cached_decode_attention(rows=)``, the
    engine's call); then the crossover with K1 over every row of a batch
    at the decode tick's depths, s = 4, 16, 64, 256, both kernels beside
    each other (``crossover`` line): the port's
    ``CONTIGUOUS_Q_TILED_MIN`` is read from it."""
    from paddle_tpu_torch.ops import (cached_decode_attention,
                                      decode_attention_cuda,
                                      decode_attention_int8_cuda)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.ops.attention import CONTIGUOUS_Q_TILED_MIN
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    nrow, L, hq, hkv, d, gr = 8, 4096, 32, 8, 128, 128
    atol, rtol = tols(bf16)

    def cache_sets(int8, n):
        if int8:
            return [(int8_payload(nrow, L, hkv, d),
                     int8_payload(nrow, L, hkv, d),
                     int8_scales(nrow, L // gr, hkv),
                     int8_scales(nrow, L // gr, hkv)) for _ in range(n)]
        return [(randn(nrow, L, hkv, d), randn(nrow, L, hkv, d))
                for _ in range(n)]

    def dense(c, r, n):
        """Rows ``r`` of a cache set as bf16 (B, n, Hkv, D) K and V (int8:
        dequantized), for the library call."""
        if len(c) == 2:
            return c[0][r, :n], c[1][r, :n]
        out = []
        for pay, sc in ((c[0], c[2]), (c[1], c[3])):
            x = pay[r].float().reshape(len(r), L // gr, gr, hkv, d)
            out.append((x * sc[r][:, :, None, :, None]).reshape(
                len(r), L, hkv, d)[:, :n].to(bf16))
        return out

    def library(q, c, r, pos_list, s):
        n = max(pos_list) + s
        k, v = dense(c, r, n)
        kj = torch.arange(n, device=dev)
        qi = (torch.tensor(pos_list, device=dev)[:, None]
              + torch.arange(s, device=dev)[None])
        mask = (kj[None, None] <= qi[:, :, None])[:, None]
        return lambda: TF.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    def traffic(int8, s, pos_list, b):
        live = sum(min(L, p + s) for p in pos_list)
        nbytes = 2 * b * s * hq * d * 2 + live * hkv * d * (1 if int8
                                                            else 2) * 2
        if int8:
            nbytes += sum(-(-min(L, p + s) // gr) for p in pos_list) \
                * hkv * 4 * 2
        ops = sum(4 * d * hq * min(p + si + 1, L)
                  for p in pos_list for si in range(s))
        return bound(nbytes, ops, BF16_FLOPS)

    for int8 in (False, True):
        name = ("flash_attention_fwd_paged_int8" if int8
                else "flash_attention_fwd_paged") + "/identity"
        note = INT8_LIBRARY_NOTE if int8 else (
            "F.scaled_dot_product_attention over the row's keys [0, pos + "
            "s), copied out beforehand (not timed)")
        s = 256
        for p in (0, 1024, 3840):
            sets = cache_sets(int8, copies((p + s) * hkv * d * 2 * 2))
            q = randn(1, s, hq, d)
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            rows = torch.tensor([5], dtype=torch.int32, device=dev)

            def run(c):
                kw = dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
                return cached_decode_attention(q, c[0], c[1], pos,
                                               rows=rows, **kw)
            got = run(sets[0])
            with reference_mode():
                want = run(sets[0])
            torch.cuda.synchronize()
            err = max_err(got, want)
            ok = within(got, want, atol, rtol) and bool(
                torch.isfinite(got).all().item())
            kfns = [lambda c=c: run(c) for c in sets]
            with reference_mode():
                plain_ms = time_ms(torch, kfns, budget_ms=100.0)
            lib_ms = time_ms(torch, [library(q, c, [5], [p], s)
                                     for c in sets[:2]])
            bms, by = traffic(int8, s, [p], 1)
            record(name,
                   f"identity view: cache B={nrow} L={L} Hq={hq} Hkv={hkv} "
                   f"D={d} block_len={gr if int8 else 64}, row 5, s={s} "
                   f"pos={p}" + (f" int8 K/V granule {gr}, bfloat16 q"
                                 if int8 else " bfloat16"),
                   err, f"atol {atol} + rtol {rtol}", ok, kfns, plain_ms,
                   lib_ms, bms, by, p == 1024, note=note)
            del sets, got, want

    # the crossover: K1 (8-row tiles, each re-reading its row's live
    # prefix) against K2-paged over the identity view, one batch
    pos_list = [0, 3000, 17, 1000, 2047, 3000, 511, 128]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    rows = torch.arange(nrow, dtype=torch.int32, device=dev)
    cross = []
    for int8 in (False, True):
        k1 = decode_attention_int8_cuda if int8 else decode_attention_cuda
        sets = cache_sets(int8, copies(sum(pos_list) * hkv * d * 2 * 2))
        for s in (4, 16, 64, 256):
            q = randn(nrow, s, hq, d)

            def kw(c):
                return dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
            got1 = k1(q, sets[0][0], sets[0][1], pos=pos, **kw(sets[0]))
            got2 = cached_decode_attention(q, sets[0][0], sets[0][1], pos,
                                           rows=rows, **kw(sets[0]))
            with reference_mode():
                want = cached_decode_attention(q, sets[0][0], sets[0][1],
                                               pos, **kw(sets[0]))
            torch.cuda.synchronize()
            bms, by = traffic(int8, s, pos_list, nrow)
            lib = [library(q, c, list(range(nrow)), pos_list, s)
                   for c in sets[:2]]
            lib_ms = time_ms(torch, lib)
            with reference_mode():
                plain_ms = time_ms(torch, [
                    lambda c=c: cached_decode_attention(q, c[0], c[1], pos,
                                                        **kw(c))
                    for c in sets[:2]], budget_ms=100.0)
            shape = (f"B={nrow} s={s} L={L} Hq={hq} Hkv={hkv} D={d} "
                     f"pos={pos_list}" + (f" int8 K/V granule {gr}"
                                          if int8 else " bfloat16"))
            row = {"s": s, "int8": int8}
            for kname, got, fns in (
                    ("decode_attention" + ("_int8" if int8 else ""), got1,
                     [lambda c=c: k1(q, c[0], c[1], pos=pos, **kw(c))
                      for c in sets]),
                    (("flash_attention_fwd_paged_int8" if int8 else
                      "flash_attention_fwd_paged") + "/identity", got2,
                     [lambda c=c: cached_decode_attention(
                         q, c[0], c[1], pos, rows=rows, **kw(c))
                      for c in sets])):
                row[kname.split("/")[0]] = record(
                    kname, "crossover: " + shape, max_err(got, want),
                    f"atol {atol} + rtol {rtol}",
                    within(got, want, atol, rtol), fns, plain_ms, lib_ms,
                    bms, by, False)["kernel_ms"]
            cross.append(row)
            del q, got1, got2, want
        del sets
    emit({"phase": "crossover", "threshold": CONTIGUOUS_Q_TILED_MIN,
          "rows": cross})


# -- phase 3 ------------------------------------------------------------------------

def phase_model(torch):
    from paddle_tpu_torch.models import (LlamaForCausalLM, draft_model_from,
                                         init_kv_cache, llama3_8b_config,
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

    def serve(m, device, reqs=prompts, new=8, **kw):
        eng = ServingEngine(m, num_slots=2, max_length=64, device=device,
                            **kw)
        rids = [eng.submit(p, max_new_tokens=new) for p in reqs]
        out = dict(eng.drain())
        return [out[r] for r in rids], eng

    (on_card, eng_card), (on_cpu, eng_cpu) = serve(tiny_card, "cuda"), \
        serve(tiny_cpu, "cpu")
    emit({"phase": "model_tiny_f32", "requests": len(prompts),
          "identical": on_card == on_cpu,
          **graph_fields(eng_card, eng_cpu)})
    check(on_card == on_cpu,
          f"tiny f32 engine differs card vs cpu: {on_card} vs {on_cpu}")
    check_graphed(eng_card, "tiny f32 engine", eng_cpu)

    # the tiny PAGED engine (block_len 16): two more prompts open with one
    # 20-token system prompt, so a suffix prefill runs at pos 16
    sys_p = rng.randint(0, tiny.vocab_size, 20).astype(np.int32)
    paged_prompts = prompts + [
        np.concatenate([sys_p, rng.randint(0, tiny.vocab_size, n).astype(
            np.int32)]) for n in (4, 13)]
    paged_kw = dict(paged=True, block_len=16)
    p_card, eng_card = serve(tiny_card, "cuda", paged_prompts, **paged_kw)
    p_cpu, eng_cpu = serve(tiny_cpu, "cpu", paged_prompts, **paged_kw)
    contiguous_card, _ = serve(tiny_card, "cuda", paged_prompts)
    hits = eng_card.kv.stats["prefix_hit_tokens"]
    emit({"phase": "model_tiny_f32_paged", "requests": len(paged_prompts),
          "block_len": 16, "prefix_hit_tokens": hits,
          "identical_card_vs_cpu": p_card == p_cpu,
          "identical_paged_vs_contiguous_card": p_card == contiguous_card,
          **graph_fields(eng_card, eng_cpu)})
    check_graphed(eng_card, "tiny f32 paged engine", eng_cpu)
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
        i_card, i_eng = serve(q_card, "cuda", reqs, **kw)
        i_cpu, i_eng_cpu = serve(q_cpu, "cpu", reqs, **kw)
        emit({"phase": "model_tiny_f32_int8", "layout": layout,
              "requests": len(reqs),
              "quantized_tensors": len(q_cpu.quantized_names),
              "identical_card_vs_cpu": i_card == i_cpu,
              **graph_fields(i_eng, i_eng_cpu)})
        check(i_card == i_cpu,
              f"tiny f32 int8 {layout} engine differs card vs cpu: "
              f"{i_card} vs {i_cpu}")
        check_graphed(i_eng, f"tiny f32 int8 {layout} engine", i_eng_cpu)

    # the tiny chunked engines (8-token chunks: most prompts span several,
    # and a later one streams in while others decode), contiguous and
    # paged under both policies, and int8 contiguous (the int8 identity
    # view): card vs CPU, both graphs built once and replayed every tick
    for layout, reqs, kw, m in (
            ("contiguous", prompts, {}, tiny_card),
            ("paged", paged_prompts, paged_kw, tiny_card),
            ("int8 contiguous", prompts, int8_kw, q_card)):
        for policy in ("prefill", "decode"):
            ckw = dict(kw, chunked=True, prefill_chunk=8,
                       chunk_policy=policy)
            c_card, c_eng = serve(m, "cuda", reqs, **ckw)
            c_cpu, c_eng_cpu = serve(q_cpu if m is q_card else tiny_cpu,
                                     "cpu", reqs, **ckw)
            cm = c_eng.metrics()
            emit({"phase": "model_tiny_f32_chunked", "layout": layout,
                  "chunk_policy": policy, "requests": len(reqs),
                  "prefill_chunks": cm["chunked"]["prefill_chunks"],
                  "mixed_ticks": cm["mixed_ticks"],
                  "decode_ticks": cm["decode_ticks"],
                  "identical_card_vs_cpu": c_card == c_cpu,
                  **graph_fields(c_eng, c_eng_cpu)})
            check(c_card == c_cpu,
                  f"tiny f32 chunked {layout} engine ({policy}) differs card "
                  f"vs cpu: {c_card} vs {c_cpu}")
            check_graphed(c_eng, f"tiny f32 chunked {layout} engine "
                          f"({policy})", c_eng_cpu)
            check(cm["mixed_ticks"] > 0 and cm["prefill_waves"] == 0,
                  f"tiny chunked {layout} engine ran no mixed tick")

    # the tiny speculative engines (spec_k 4, the n-gram drafter):
    # contiguous, paged, chunked (8-token chunks), and the draft model (a
    # 1-layer draft_model_from of each side's model): card vs CPU, the
    # tokens and every metrics()["spec"] counter identical, the verify
    # step (and the draft steps) built once and replayed
    for layout, reqs, kw, layers in (
            ("contiguous", prompts, {}, 0),
            ("paged", paged_prompts, paged_kw, 0),
            ("chunked", prompts, dict(chunked=True, prefill_chunk=8), 0),
            ("model drafter", prompts, {}, 1)):
        kw = dict(kw, spec_decode=True, spec_k=SPEC_K)
        card_kw, cpu_kw = dict(kw), dict(kw)
        if layers:
            card_kw.update(drafter="model", draft_model=draft_model_from(
                tiny_card, num_layers=layers))
            cpu_kw.update(drafter="model", draft_model=draft_model_from(
                tiny_cpu, num_layers=layers))
        # 16 new tokens: the n-gram drafter needs some history to match
        s_card, s_eng = serve(tiny_card, "cuda", reqs, new=16, **card_kw)
        s_cpu, s_eng_cpu = serve(tiny_cpu, "cpu", reqs, new=16, **cpu_kw)
        sm, sm_cpu = s_eng.metrics(), s_eng_cpu.metrics()
        emit({"phase": "model_tiny_f32_spec", "layout": layout,
              "requests": len(reqs), "spec": sm["spec"],
              "identical_card_vs_cpu": s_card == s_cpu,
              "spec_identical_card_vs_cpu": sm["spec"] == sm_cpu["spec"],
              "draft_traces": sm["draft_traces"],
              **graph_fields(s_eng, s_eng_cpu)})
        what = f"tiny f32 spec {layout} engine"
        check(s_card == s_cpu,
              f"{what} differs card vs cpu: {s_card} vs {s_cpu}")
        check(sm["spec"] == sm_cpu["spec"],
              f"{what}: spec counters differ card vs cpu: {sm['spec']} vs "
              f"{sm_cpu['spec']}")
        check(sm["spec"]["drafted_tokens"] > 0, f"{what} drafted nothing")
        check_graphed(s_eng, what, s_eng_cpu)
        if layers:
            d = s_eng._drafters["model"]
            check(d.draft_traces == 1 and d.ingest_traces == 1
                  and d.graphed, f"{what}: draft steps built "
                  f"{d.draft_traces} / {d.ingest_traces} times, graphed "
                  f"{d.graphed}")
    return model, qmodel


# -- the once-built decode step ----------------------------------------------------

def graph_contract(m, graphed: bool):
    """What an engine's ``metrics()`` break of the steps' contract: one
    build (``step_traces`` 1, the reference's retrace budget; the chunked
    engine's decode step too), one graph replay a decode tick (and a
    mixed tick, chunked) and one prefill-graph replay a wave for a
    graphed engine, none for an eager one.  Returns the failures as text,
    [] when the contract holds."""
    bad = []
    if m["step_traces"] != 1:
        bad.append(f"step_traces {m['step_traces']} (want 1)")
    if m.get("decode_step_traces", 1) != 1:
        bad.append(f"decode_step_traces {m['decode_step_traces']} "
                   f"(want 1)")
    ticks = m["decode_ticks"] + m.get("mixed_ticks", 0)
    want = ticks if graphed else 0
    if m["graph_replays"] != want:
        bad.append(f"graph_replays {m['graph_replays']} for "
                   f"{ticks} ticks (want {want})")
    waves = m.get("prefill_waves", 0)
    want = waves if graphed else 0
    if m.get("prefill_graph_replays", 0) != want:
        bad.append(f"prefill_graph_replays {m['prefill_graph_replays']} "
                   f"for {waves} waves (want {want})")
    return bad


def check_graph(run, what, graphed=True):
    """Fail unless a serving run (``graphed``, ``metrics``) replayed a
    CUDA graph exactly when ``graphed`` and kept :func:`graph_contract`,
    and, where the run recorded its waves' (bucket, rows) keys
    (``wave_keys``), built one prefill step a distinct key."""
    check(run["graphed"] == graphed,
          f"{what}: the engine's graphed is {run['graphed']}, want {graphed}")
    bad = graph_contract(run["metrics"], graphed)
    check(not bad, f"{what}: " + "; ".join(bad))
    if "wave_keys" in run:
        keys = set(run["wave_keys"])
        check(run["metrics"]["prefill_traces"] == len(keys),
              f"{what}: prefill_traces {run['metrics']['prefill_traces']} "
              f"for {len(keys)} distinct wave keys {sorted(keys)}")


def graph_fields(eng, cpu=None):
    m = eng.metrics()
    out = {"graphed": eng.graphed, "step_traces": m["step_traces"],
           "graph_replays": m["graph_replays"],
           "prefill_traces": m["prefill_traces"],
           "prefill_graph_replays": m["prefill_graph_replays"]}
    if cpu is not None:
        out["prefill_traces_cpu"] = cpu.prefill_traces
    return out


def check_graphed(eng, what, cpu=None):
    """:func:`check_graph` of an engine; with ``cpu``, the same engine on
    the CPU, its ``prefill_traces`` must be the card's."""
    check_graph({"graphed": eng.graphed, "metrics": eng.metrics()}, what)
    if cpu is not None:
        check(eng.prefill_traces == cpu.prefill_traces,
              f"{what}: prefill_traces {eng.prefill_traces} on the card, "
              f"{cpu.prefill_traces} on the CPU")


def twin_comparison(graphed, eager):
    """The eager twin's token check: ``graphed`` and ``eager`` hold each
    request's tokens in submit order.  Returns ``tokens_identical``, the
    indices of the requests that differ and the first difference as
    [request, position, graphed token, eager token] (None past a shorter
    output), or None."""
    if len(graphed) != len(eager):
        raise ValueError(f"{len(graphed)} graphed outputs against "
                         f"{len(eager)} eager ones")
    differing = [i for i, (g, e) in enumerate(zip(graphed, eager)) if g != e]
    first = None
    if differing:
        g, e = graphed[differing[0]], eager[differing[0]]
        j = next((j for j, (a, b) in enumerate(zip(g, e)) if a != b),
                 min(len(g), len(e)))
        first = [differing[0], j, g[j] if j < len(g) else None,
                 e[j] if j < len(e) else None]
    return {"tokens_identical": not differing,
            "requests_differing": differing, "first_difference": first}


# -- phase 4 ------------------------------------------------------------------------

def serving_prompts(vocab: int):
    import numpy as np
    rng = np.random.RandomState(1)
    lengths = (5, 1500, 37, 700, 12, 260, 1023, 90, 8, 1200, 400, 64)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def phase_serving(torch, model, kernels):
    prompts = serving_prompts(model.config.vocab_size)
    run = _serve_8b(torch, model, prompts, warm=True)
    twin = eager_twin(torch, model, prompts, run, "phase 4")
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    emit({"phase": "serving", "requests": len(prompts),
          "prompt_lengths": [int(p.size) for p in prompts],
          "new_tokens": 32, **serving_fields(run),
          "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"], "launches": launches,
          "routes": routes, "warm": warm_fields(run), "eager_twin": twin})
    check_graph(run, "phase 4")
    check_twin(twin, "phase 4")
    check_warm(run, "phase 4")
    for name in CONTIGUOUS_PATH:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
        kernels[name]["launches"] = launches[name]
    check(launches["decode_attention"] == LAYERS_8B * m["decode_ticks"],
          f"K1 launched {launches['decode_attention']} times for "
          f"{m['decode_ticks']} decode ticks")
    plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
    check(not plain, f"plain routes taken on the card: {plain}")
    return run


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
    kw = dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS)
    prompts = paged_serving_prompts(model.config.vocab_size)
    run = _serve_8b(torch, model, prompts, **kw)
    twin = eager_twin(torch, model, prompts, run, "phase 4b", **kw)
    m, launches, paths = run["metrics"], run["launches"], run["routes"]
    kv = m["kv_cache"]
    emit({"phase": "serving_paged", "requests": len(prompts),
          "prompt_lengths": [int(p.size) for p in prompts],
          "block_len": 128, "num_blocks": PAGED_POOL_BLOCKS,
          "new_tokens": 32, **serving_fields(run),
          "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"],
          "prefill_tokens_computed": m["prefill_tokens_computed"],
          "prefill_tokens_total": m["prefill_tokens_total"],
          "kv_cache": kv, "launches": launches, "routes": paths,
          "eager_twin": twin})
    check_graph(run, "phase 4b")
    check_twin(twin, "phase 4b")
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
    return run


# the engine's latency series (metrics() key -> its _Hist) and counters
# that a pass of a reused engine reads as its own share
PASS_HISTS = {"ttft_ms": "_m_ttft", "tpot_ms": "_m_tpot",
              "queue_wait_ms": "_m_queue_wait",
              "decode_step_ms": "_m_step_ms",
              "prefill_wave_ms": "_m_prefill_ms",
              "mixed_step_ms": "_m_mixed_ms"}
PASS_COUNTS = ("requests_finished", "tokens_generated", "prefill_waves",
               "ticks", "decode_ticks", "mixed_ticks", "graph_replays",
               "prefill_graph_replays", "prefill_tokens_computed",
               "prefill_tokens_total")


def _serve_8b(torch, model, prompts, new_tokens=32, warm=False,
              submit_kw=None, warm_kw=None, **kw):
    """One 8B-width serving run: the engine is built (its decode step's
    warm-up and graph capture included, unless ``disable_graphs()`` is
    open), then every launch and route counter is reset just before the
    requests are submitted and read just after the drain.  Returns the run
    as a dict: outputs in submit order, wall seconds, launches, routes,
    the engine's metrics, whether it replayed a graph, the (bucket, rows)
    key of every wave (``wave_keys``) and the peak of allocated device
    memory over the pass; the prefill steps are built inside this (cold)
    pass, on each key's first use.  ``warm``: then serve the same
    requests again on the same engine, as ``run["warm"]`` (metrics,
    launches and routes of that pass alone).  ``submit_kw``: each
    request's extra ``submit`` arguments (a speculative phase's
    drafters); ``warm_kw(cold run)``: the warm pass's, when they differ.
    The engine is freed."""
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, num_slots=8, max_length=4096,
                        prefill_batch=4, device="cuda", **kw)
    keys = []
    for name in ("_prefill", "_prefill_paged"):
        def record(ids, *args, _fn=getattr(eng, name), **kwargs):
            keys.append((int(ids.shape[1]), int(ids.shape[0])))
            return _fn(ids, *args, **kwargs)
        setattr(eng, name, record)
    run = _serve_pass(torch, eng, prompts, new_tokens, keys, submit_kw)
    if warm:
        run["warm"] = _serve_pass(torch, eng, prompts, new_tokens, keys,
                                  warm_kw(run) if warm_kw else submit_kw)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _serve_pass(torch, eng, prompts, new_tokens, keys, submit_kw=None):
    """One pass of ``prompts`` through ``eng`` (see :func:`_serve_8b`):
    counters, latency series and wave keys of this pass alone; a draft
    model's builds and step runs under ``draft``."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.serving.engine import _Hist

    before = eng.metrics()
    marks = {k: len(getattr(eng, h).values) for k, h in PASS_HISTS.items()}
    spec_marks = spec_hist_marks(eng)
    k0 = len(keys)
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    submit_kw = submit_kw or [{}] * len(prompts)
    rids = [eng.submit(p, max_new_tokens=new_tokens, **skw)
            for p, skw in zip(prompts, submit_kw)]
    out = dict(eng.drain())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics()
    for k in PASS_COUNTS:
        if k in m:
            m[k] -= before[k]
    for k, h in PASS_HISTS.items():
        if k in m:
            part = _Hist()
            part.values = getattr(eng, h).values[marks[k]:]
            m[k] = part.summary()
    if "spec" in m:
        m["spec"] = spec_pass(m["spec"], before["spec"], eng, spec_marks)
    run = {"outs": [out[r] for r in rids], "wall": wall,
           "launches": ops.launch_counts(),
           "routes": {f"{op}/{path}": n for (op, path), n in
                      _dispatch.kernel_paths.items()},
           "metrics": m, "graphed": eng.graphed,
           "wave_keys": keys[k0:],
           "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2**30,
                                   3),
           "cache_bytes": eng.cache_hbm_bytes}
    dm = getattr(eng, "_drafters", {}).get("model")
    if dm is not None:
        run["draft"] = {"draft_traces": dm.draft_traces,
                        "ingest_traces": dm.ingest_traces,
                        "graphed": dm.graphed, "draft_runs": dm.draft_runs,
                        "ingest_runs": dm.ingest_runs}
    vocab = eng.config.vocab_size
    for r, o in zip(rids, run["outs"]):
        check(len(o) == new_tokens, f"request {r} returned {len(o)} tokens")
        check(all(0 <= t < vocab for t in o),
              f"request {r} returned a token outside the vocabulary")
    return run


SPEC_COUNTS = ("drafted_tokens", "draft_hit_tokens", "draft_miss_tokens",
               "rollbacks")


def spec_hist_marks(eng):
    """Where each accepted-per-step series of a speculative engine stands
    (engine total and by drafter kind), so a pass reads its own share."""
    if not getattr(eng, "spec", False):
        return {}
    marks = {None: len(eng._spec_total.accept.values)}
    marks.update({k: len(c.accept.values)
                  for k, c in eng._spec_kinds.items()})
    return marks


def spec_pass(now, before, eng, marks):
    """A pass's share of the engine's ``metrics()["spec"]`` block: the
    counts less ``before``'s, the accepted-per-step series from
    ``marks`` on (:func:`spec_hist_marks`)."""
    from paddle_tpu_torch.serving.engine import _Hist

    def share(cur, old, values, mark):
        out = dict(cur)
        for k in SPEC_COUNTS:
            out[k] = cur[k] - (old or {}).get(k, 0)
        out["draft_hit_rate"] = (round(out["draft_hit_tokens"]
                                       / out["drafted_tokens"], 3)
                                 if out["drafted_tokens"] else 0.0)
        h = _Hist()
        h.values = values[mark:]
        out["accepted_per_step"] = h.summary()
        return out
    out = share(now, before, eng._spec_total.accept.values, marks[None])
    if "by_drafter" in now:
        out["by_drafter"] = {
            k: share(v, before.get("by_drafter", {}).get(k),
                     eng._spec_kinds[k].accept.values, marks.get(k, 0))
            for k, v in now["by_drafter"].items()}
    return out


def serving_fields(run):
    """The timing and graph fields of a serving run's JSON line."""
    m = run["metrics"]
    ntok = sum(len(o) for o in run["outs"])
    out = {"tokens": ntok, "wall_s": round(run["wall"], 4),
           "tok_per_s": round(ntok / run["wall"], 2),
           "decode_step_ms": m["decode_step_ms"], "ttft_ms": m["ttft_ms"],
           "tpot_ms": m["tpot_ms"], "prefill_wave_ms": m["prefill_wave_ms"],
           "peak_memory_gb": run["peak_memory_gb"],
           "graphed": run["graphed"], "step_traces": m["step_traces"],
           "graph_replays": m["graph_replays"],
           "prefill_traces": m["prefill_traces"],
           "prefill_graph_replays": m["prefill_graph_replays"],
           "wave_keys": sorted(set(run["wave_keys"]))}
    if "mixed_ticks" in m:
        out.update(mixed_step_ms=m["mixed_step_ms"],
                   mixed_ticks=m["mixed_ticks"],
                   decode_ticks=m["decode_ticks"],
                   decode_step_traces=m["decode_step_traces"],
                   chunked=m["chunked"])
    return out


def warm_fields(run):
    """The warm pass's line (``run["warm"]``): its timings, builds and
    replays, and whether its tokens and launches are the cold pass's."""
    w = run["warm"]
    return {**serving_fields(w),
            "prefill_waves": w["metrics"]["prefill_waves"],
            "tokens_identical_to_cold": w["outs"] == run["outs"],
            "launches_identical_to_cold": w["launches"] == run["launches"]}


def check_warm(run, what):
    """The warm pass builds nothing (``prefill_traces`` as after the cold
    pass), replays every wave and repeats the cold pass's tokens."""
    w = run["warm"]
    wm = w["metrics"]
    check(wm["prefill_traces"] == run["metrics"]["prefill_traces"],
          f"{what} warm pass: prefill_traces {wm['prefill_traces']} after "
          f"{run['metrics']['prefill_traces']} (a key was built again)")
    check(set(w["wave_keys"]) <= set(run["wave_keys"]),
          f"{what} warm pass: new wave keys "
          f"{sorted(set(w['wave_keys']) - set(run['wave_keys']))}")
    check(wm["prefill_waves"] > 0
          and wm["prefill_graph_replays"] == wm["prefill_waves"],
          f"{what} warm pass: {wm['prefill_graph_replays']} prefill replays "
          f"for {wm['prefill_waves']} waves")
    check_graph(dict(w, wave_keys=run["wave_keys"] + w["wave_keys"]),
                f"{what} warm pass")
    check(w["outs"] == run["outs"],
          f"{what} warm pass: tokens differ from the cold pass's")


def eager_twin(torch, model, prompts, run, what, submit_kw=None, **kw):
    """The same engine on the same requests with its decode step run
    eagerly (``disable_graphs()``, the port's ``jax.disable_jit()``).
    Returns the twin's line: its timings, its graph fields, the token
    comparison with the graphed ``run`` and whether its launch and route
    counts equal the graphed run's (the replay accounting credits what
    the eager ticks launch, no more and no less)."""
    from paddle_tpu_torch.serving import disable_graphs

    with disable_graphs():
        twin = _serve_8b(torch, model, prompts, submit_kw=submit_kw, **kw)
    check_graph(twin, f"{what} eager twin", graphed=False)
    out = {**serving_fields(twin),
           **twin_comparison(run["outs"], twin["outs"]),
           "launches_identical": twin["launches"] == run["launches"],
           "routes_identical": twin["routes"] == run["routes"]}
    if "draft" in twin:
        out["draft"] = twin["draft"]
    if "spec" in twin["metrics"]:
        out["spec_identical"] = (twin["metrics"]["spec"]
                                 == run["metrics"]["spec"])
    return out


def check_twin(twin, what):
    check(twin["tokens_identical"],
          f"{what}: the graphed engine's tokens differ from its eager "
          f"twin's: requests {twin['requests_differing']}, first "
          f"[request, position, graphed, eager] "
          f"{twin['first_difference']}")
    check(twin["launches_identical"] and twin["routes_identical"],
          f"{what}: the eager twin's launches or routes differ from the "
          f"graphed engine's (replay accounting)")


def _check_int8_launches(what, m, launches, routes, attention):
    """The int8 engine's launch contract: :func:`check_attention_launches`
    and K4 at least 7 x 32 + 1 times a decode tick."""
    check_attention_launches(what, launches, routes,
                             attention_launches(m, attention))
    check(launches["int8_matmul"] >= K4_PER_TICK * m["decode_ticks"],
          f"{what}: K4 launched {launches['int8_matmul']} times for "
          f"{m['decode_ticks']} decode ticks")


def phase_serving_int8(torch, qmodel, kernels, paged_metrics):
    """Phase 4c: phase 4b's engine, requests and pool, int8 KV + int8
    weights; the schedule must be phase 4b's."""
    kw = dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS,
              kv_cache_dtype="int8", int8_weights=True)
    prompts = paged_serving_prompts(qmodel.config.vocab_size)
    run = _serve_8b(torch, qmodel, prompts, **kw)
    twin = eager_twin(torch, qmodel, prompts, run, "phase 4c", **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    kv = m["kv_cache"]
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
          "new_tokens": 32, **serving_fields(run),
          "schedule": schedule, "kv_cache": kv,
          "pool_bytes": run["cache_bytes"],
          "model_hbm_bytes": hbm_q, "model_hbm_bytes_unquantized": hbm_full,
          "launches": launches, "routes": routes, "eager_twin": twin})
    check_graph(run, "phase 4c")
    check_twin(twin, "phase 4c")
    check(schedule == PAGED_SCHEDULE,
          f"phase 4c schedule {schedule} is not {PAGED_SCHEDULE}")
    check(all(schedule[k] == (paged_metrics["kv_cache"] if k in (
        "evictions", "admission_blocked") else paged_metrics)[k]
        for k in schedule), "phase 4c schedule differs from phase 4b's")
    check(kv["kv_dtype"] == "int8" and kv["quantized_blocks"] > 0,
          "the int8 pool holds no int8 block")
    check(kv["blocks_in_use"] == 0, "blocks still in use after the drain")
    _check_int8_launches("phase 4c", m, launches, routes,
                         {"decode_attention_paged_int8": ("tick",),
                          "flash_attention_fwd_paged_int8": ("wave",)})
    for name in ("decode_attention_paged_int8",
                 "flash_attention_fwd_paged_int8", "int8_matmul"):
        kernels[name]["launches"] = launches[name]
    return run


def phase_serving_int8_contiguous(torch, qmodel, kernels, metrics4):
    """Phase 4d: phase 4's engine and requests, int8 KV + int8 weights."""
    kw = dict(kv_cache_dtype="int8", int8_weights=True)
    prompts = serving_prompts(qmodel.config.vocab_size)
    run = _serve_8b(torch, qmodel, prompts, warm=True, **kw)
    twin = eager_twin(torch, qmodel, prompts, run, "phase 4d", **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    emit({"phase": "serving_int8_contiguous", "requests": len(prompts),
          "kv_cache_dtype": "int8", "int8_weights": True, "new_tokens": 32,
          **serving_fields(run), "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"],
          "cache_bytes": run["cache_bytes"], "launches": launches,
          "routes": routes, "warm": warm_fields(run), "eager_twin": twin})
    check_graph(run, "phase 4d")
    check_twin(twin, "phase 4d")
    check_warm(run, "phase 4d")
    check((m["prefill_waves"], m["decode_ticks"])
          == (metrics4["prefill_waves"], metrics4["decode_ticks"]),
          "phase 4d schedule differs from phase 4's")
    _check_int8_launches("phase 4d", m, launches, routes,
                         {"decode_attention_int8": ("tick",),
                          "flash_attention_fwd": ("wave",)})
    kernels["decode_attention_int8"]["launches"] = \
        launches["decode_attention_int8"]
    return run


# the chunked phases: (phase, engine options, attention kernels and the
# ticks each runs on: "tick" every tick's decode rows, "mixed" every chunk)
CHUNKED_PHASES = (
    ("4e", "serving_chunked", dict(chunk_policy="prefill"),
     {"decode_attention": ("ticks",),
      "flash_attention_fwd_paged": ("mixed",)}),
    ("4f", "serving_chunked_paged",
     dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS,
          chunk_policy="decode"),
     {"decode_attention_paged": ("ticks",),
      "flash_attention_fwd_paged": ("mixed",)}),
    ("4g", "serving_chunked_int8",
     dict(kv_cache_dtype="int8", int8_weights=True, chunk_policy="prefill"),
     {"decode_attention_int8": ("ticks",),
      "flash_attention_fwd_paged_int8": ("mixed",)}))
ATTENTION_KERNELS = ("decode_attention", "flash_attention_fwd",
                     "decode_attention_paged", "flash_attention_fwd_paged",
                     "decode_attention_int8", "decode_attention_paged_int8",
                     "flash_attention_fwd_paged_int8")


def phase_serving_chunked(torch, model, kernels, phase, label, kw,
                          attention, prompts, wave_outs):
    """Phases 4e-4g: chunked prefill at the 8B width (``prefill_chunk``
    256), graphed, then its eager twin.  Gates: tokens, launches and
    routes equal to the twin's; ``step_traces`` 1 and the decode step
    built once; one replay a tick; each attention kernel of ``attention``
    32 times a tick (``tick``: every tick's decode rows) or a chunk
    (``mixed``), every other attention kernel never (no wave prefill, no
    K2); K4 at least 7 x 32 + 1 a step pass with int8 weights; no plain
    route.  Reports the share of requests whose tokens equal the wave
    phase's (``wave_outs``): chunking changes bf16 sum order, so that is
    not gated."""
    kw = dict(kw, chunked=True, prefill_chunk=256)
    run = _serve_8b(torch, model, prompts, **kw)
    twin = eager_twin(torch, model, prompts, run, f"phase {phase}", **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    same = sum(a == b for a, b in zip(run["outs"], wave_outs))
    line = {"phase": label, "requests": len(prompts),
            "prompt_lengths": [int(p.size) for p in prompts],
            "new_tokens": 32, **kw, **serving_fields(run),
            "ticks": m["ticks"], "launches": launches, "routes": routes,
            "same_tokens_as_wave_phase": f"{same}/{len(prompts)}",
            "eager_twin": twin}
    if "kv_cache" in m:
        line["kv_cache"] = m["kv_cache"]
    emit(line)
    what = f"phase {phase}"
    check_graph(run, what)
    check_twin(twin, what)
    check(m["prefill_waves"] == 0 and m["mixed_ticks"] > 0,
          f"{what}: prefill waves {m['prefill_waves']}, mixed ticks "
          f"{m['mixed_ticks']}")
    check_attention_launches(what, launches, routes,
                             attention_launches(m, attention))
    if kw.get("int8_weights"):
        passes = m["ticks"] + m["mixed_ticks"]
        check(launches["int8_matmul"] >= K4_PER_TICK * passes,
              f"{what}: K4 launched {launches['int8_matmul']} times for "
              f"{passes} model passes")
    if kw.get("paged"):
        check(m["kv_cache"]["prefix_hit_tokens"] > 0,
              f"{what}: no prefix hit on the shared prompt")
        check(m["kv_cache"]["blocks_in_use"] == 0,
              f"{what}: blocks still in use after the drain")
    if not kw.get("paged"):
        name = [n for n, u in attention.items() if u == ("mixed",)][0]
        kernels[name + "/identity"]["launches"] = launches[name]
    return run


# -- the speculative phases (4h-4k) ----------------------------------------------

SPEC_K = 4
# the draft model of phase 4k: the target's first 2 of 32 layers
DRAFT_LAYERS = 2


class ScriptDrafter:
    """A host drafter that proposes a request's known continuation: the
    tokens ``stream`` (the same request's output in an earlier phase)
    after what the request has generated so far, with the draft at column
    2 changed when ``corrupt`` (a rejection inside every full window).
    Random weights and prompts give the n-gram drafter few hits, so half
    of each speculative phase's requests carry one of these."""

    kind = "scripted"
    uses_device = False

    def __init__(self, prompt, stream, k, vocab, corrupt):
        self.prompt, self.stream = prompt, list(stream)
        self.k, self.vocab, self.corrupt = k, vocab, corrupt

    def propose(self, history):
        import numpy as np
        g = len(history) - len(self.prompt)
        prop = self.stream[g:g + self.k]
        if self.corrupt and len(prop) > 2:
            prop = prop[:2] + [(prop[2] + 1) % self.vocab] + prop[3:]
        return np.asarray(prop, np.int32)

    def reset_slot(self, i):
        pass


def spec_submit_kw(prompts, streams, vocab):
    """Phases 4h-4j's drafters: even requests a :class:`ScriptDrafter` of
    the non-speculative phase's output (every other one corrupted at
    column 2), odd requests the n-gram drafter."""
    return [{"drafter": ScriptDrafter(p, o, SPEC_K, vocab, corrupt=i % 4 == 2)
             if i % 2 == 0 else "ngram"}
            for i, (p, o) in enumerate(zip(prompts, streams))]


def spec_fields(run, base):
    """A speculative run's report beside its non-speculative phase's
    (``base``): tok/s, TPOT p50, step ms p50 (the verify tick), the mean
    accepted tokens a step, peak memory, and how many requests' tokens
    equal the base phase's (bf16 sums differ between s = 1 and s = 5, so
    this is reported, not gated)."""
    def one(r):
        m = r["metrics"]
        ntok = sum(len(o) for o in r["outs"])
        return {"tok_per_s": round(ntok / r["wall"], 2),
                "tpot_ms_p50": m["tpot_ms"].get("p50"),
                "step_ms_p50": m["decode_step_ms"].get("p50"),
                "mixed_step_ms_p50": m.get("mixed_step_ms", {}).get("p50"),
                "peak_memory_gb": r["peak_memory_gb"]}
    same = sum(a == b for a, b in zip(run["outs"], base["outs"]))
    sp = run["metrics"]["spec"]
    return {"spec": sp, "accepted_per_step_mean":
            sp["accepted_per_step"].get("mean"),
            "this_run": one(run), "non_spec_phase": one(base),
            "same_tokens_as_non_spec": f"{same}/{len(run['outs'])}"}


def attention_launches(m, attention):
    """The launches each kernel of ``attention`` owes a run with metrics
    ``m``: 32 a unit (name -> units: "tick" every decode or verify tick,
    "wave" every prefill wave, "mixed" every chunk, "ticks" every tick of
    a chunked engine)."""
    per = {"tick": m["decode_ticks"], "wave": m["prefill_waves"],
           "mixed": m.get("mixed_ticks", 0), "ticks": m["ticks"]}
    return {name: LAYERS_8B * sum(per[u] for u in units)
            for name, units in attention.items()}


def check_attention_launches(what, launches, routes, want):
    """Each kernel of ``want`` launched exactly its count there, every
    other attention kernel never, RMSNorm on every layer, no plain
    route."""
    for name, n in want.items():
        check(launches[name] == n,
              f"{what}: {name} launched {launches[name]} times, want {n}")
    others = [n for n in ATTENTION_KERNELS
              if n not in want and launches[n]]
    check(not others, f"{what}: attention kernels off this path ran: "
          f"{others}")
    check(launches["rms_norm"] > 0, f"{what}: RMSNorm kernel not launched")
    plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
    check(not plain, f"{what}: plain routes taken on the card: {plain}")


# (phase, line label, engine options, attention kernels and their units)
SPEC_PHASES = (
    ("4h", "serving_spec", dict(),
     {"decode_attention": ("tick",), "flash_attention_fwd": ("wave",)}),
    ("4i", "serving_spec_paged",
     dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS),
     {"flash_attention_fwd_paged": ("tick", "wave")}),
    ("4j", "serving_spec_int8",
     dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS,
          kv_cache_dtype="int8", int8_weights=True),
     {"flash_attention_fwd_paged_int8": ("tick", "wave")}))


def phase_serving_spec(torch, model, phase, label, kw, attention, prompts,
                       base):
    """Phases 4h-4j: the speculative engine (``spec_k`` 4) on a
    non-speculative phase's engine, requests and pool (``base``: that
    phase's run), graphed, then its eager twin.  Half the requests draft
    with a :class:`ScriptDrafter` of ``base``'s output, half with the
    n-gram drafter.  Gates: the verify step built once, one graph replay
    a tick, tokens / launches / routes / spec counters equal to the
    twin's; ``drafted_tokens``, ``draft_hit_tokens`` and ``rollbacks``
    > 0; each attention kernel 32 times its units (the verify window:
    K1 at s = 5 contiguous, K2-paged(-int8) paged), no other attention
    kernel, no plain route; paged: prefix hits > 0 and no block in use
    after the drain (``truncate_to`` gave back every draft block); int8
    weights: K4 at least 7 x 32 + 1 a tick.

    Where ``base`` has a warm pass (phase 4), the engine serves the
    requests a second time (``warm``), its scripted drafters replaying the
    speculative cold pass's own output: no new build, a replay a wave and
    a tick, hits > 0; reported beside ``base``'s warm pass, with whether
    its tokens equal the cold pass's."""
    kw = dict(kw, spec_decode=True, spec_k=SPEC_K)
    vocab = model.config.vocab_size
    skw = spec_submit_kw(prompts, base["outs"], vocab)
    warm = "warm" in base
    run = _serve_8b(torch, model, prompts, submit_kw=skw, warm=warm,
                    warm_kw=lambda cold: spec_submit_kw(prompts, cold["outs"],
                                                        vocab), **kw)
    what = f"phase {phase}"
    twin = eager_twin(torch, model, prompts, run, what, submit_kw=skw, **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    line = {"phase": label, "requests": len(prompts),
            "prompt_lengths": [int(p.size) for p in prompts],
            "new_tokens": 32, **{k: v for k, v in kw.items()},
            **serving_fields(run), **spec_fields(run, base),
            "prefill_waves": m["prefill_waves"],
            "decode_ticks": m["decode_ticks"], "launches": launches,
            "routes": routes, "eager_twin": twin}
    if "kv_cache" in m:
        line["kv_cache"] = m["kv_cache"]
    if warm:
        w = run["warm"]
        line["warm"] = {**serving_fields(w), **spec_fields(w, base["warm"]),
                        "tokens_identical_to_cold": w["outs"] == run["outs"]}
    emit(line)
    check_graph(run, what)
    check_twin(twin, what)
    if warm:
        wm = w["metrics"]
        check(wm["prefill_traces"] == m["prefill_traces"]
              and wm["prefill_graph_replays"] == wm["prefill_waves"],
              f"{what} warm pass: prefill_traces {wm['prefill_traces']} "
              f"after {m['prefill_traces']}, {wm['prefill_graph_replays']} "
              f"replays for {wm['prefill_waves']} waves")
        check_graph(dict(w, wave_keys=run["wave_keys"] + w["wave_keys"]),
                    f"{what} warm pass")
        check(wm["spec"]["draft_hit_tokens"] > 0,
              f"{what} warm pass: no draft hit")
    check(twin["spec_identical"],
          f"{what}: the eager twin's spec counters differ")
    sp = m["spec"]
    for key in ("drafted_tokens", "draft_hit_tokens", "rollbacks"):
        check(sp[key] > 0, f"{what}: spec {key} is {sp[key]}")
    check_attention_launches(what, launches, routes,
                             attention_launches(m, attention))
    if kw.get("int8_weights"):
        check(launches["int8_matmul"] >= K4_PER_TICK * m["decode_ticks"],
              f"{what}: K4 launched {launches['int8_matmul']} times for "
              f"{m['decode_ticks']} verify ticks")
    if kw.get("paged"):
        check(m["kv_cache"]["prefix_hit_tokens"] > 0,
              f"{what}: no prefix hit on the shared prompt")
        check(m["kv_cache"]["blocks_in_use"] == 0,
              f"{what}: blocks still in use after the drain")
    return run


def phase_serving_spec_chunked_model(torch, model, prompts, base):
    """Phase 4k: phase 4e's engine (contiguous, ``chunked=True,
    prefill_chunk=256``) speculating with a draft model, the target's
    first ``DRAFT_LAYERS`` layers (``draft_model_from``: the same
    storage), graphed, then its eager twin.  Gates: the mixed step and
    the verify step built once each, one replay a tick; the draft step
    built once (``draft_traces`` 1) and the ingest step once, both
    graphed (the twin's not); tokens, launches, routes and spec counters
    equal to the twin's; ``drafted_tokens`` > 0; K1 32 a tick (the verify
    half of every tick, s = 5) plus the draft model's 2 + 2 x 3 a draft
    step (its window at s = 5 and three one-token steps), K2-paged over
    the identity view 32 a chunk plus 2 an ingest step (16 tokens a row),
    no other attention kernel, no plain route.  ``base``: phase 4e's
    run."""
    from paddle_tpu_torch.models import draft_model_from

    dm = draft_model_from(model, num_layers=DRAFT_LAYERS)
    kw = dict(chunked=True, prefill_chunk=256, chunk_policy="prefill",
              spec_decode=True, spec_k=SPEC_K, drafter="model",
              draft_model=dm)
    run = _serve_8b(torch, model, prompts, **kw)
    what = "phase 4k"
    twin = eager_twin(torch, model, prompts, run, what, **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    dr = run["draft"]
    line = {"phase": "serving_spec_chunked_model", "requests": len(prompts),
            "prompt_lengths": [int(p.size) for p in prompts],
            "new_tokens": 32, "chunked": True, "prefill_chunk": 256,
            "spec_k": SPEC_K, "drafter": "model",
            "draft_layers": DRAFT_LAYERS, **serving_fields(run),
            **spec_fields(run, base), "ticks": m["ticks"],
            "draft": dr, "launches": launches, "routes": routes,
            "eager_twin": twin}
    emit(line)
    check_graph(run, what)
    check_twin(twin, what)
    check(twin["spec_identical"],
          f"{what}: the eager twin's spec counters differ")
    check(dr["draft_traces"] == 1 and dr["ingest_traces"] == 1
          and m["draft_traces"] == 1,
          f"{what}: draft steps built {dr['draft_traces']} / "
          f"{dr['ingest_traces']} times")
    check(dr["graphed"] and not twin["draft"]["graphed"],
          f"{what}: the draft steps' graphs: {dr['graphed']}, twin "
          f"{twin['draft']['graphed']}")
    check(m["spec"]["drafted_tokens"] > 0, f"{what}: nothing drafted")
    check(m["prefill_waves"] == 0 and m["mixed_ticks"] > 0,
          f"{what}: prefill waves {m['prefill_waves']}, mixed ticks "
          f"{m['mixed_ticks']}")
    # beside the target's, the draft model's launches: its window and
    # k - 1 one-token steps a draft step (K1), one pass an ingest step
    # (K2-paged over the identity view), DRAFT_LAYERS each
    want = attention_launches(m, {"decode_attention": ("ticks",),
                                  "flash_attention_fwd_paged": ("mixed",)})
    want["decode_attention"] += DRAFT_LAYERS * SPEC_K * dr["draft_runs"]
    want["flash_attention_fwd_paged"] += DRAFT_LAYERS * dr["ingest_runs"]
    check_attention_launches(what, launches, routes, want)
    return run


def device_us(prof, n: int):
    """Device time per call (us) by kernel name from a profiler window of
    ``n`` calls."""
    return {k[:60]: round(t / n, 3) for t, k, _ in kernel_rows(prof)}


def split_sweep(torch, fns, splits):
    """{split length: device us of one call (all its kernels) over 40
    calls cycling ``fns``}, FLAGS_decode_attention_block_kv restored
    after."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import flags

    default_split = flags.flag("decode_attention_block_kv")
    sweep = {}
    try:
        for split in splits:
            flags.set_flags({"decode_attention_block_kv": split})
            for f in fns:
                f()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(40):
                    fns[i % len(fns)]()
                torch.cuda.synchronize()
            sweep[split] = round(sum(device_us(prof, 40).values()), 3)
    finally:
        flags.set_flags({"decode_attention_block_kv": default_split})
    return sweep


def paged_split_sweep(torch, gen):
    """K1-paged's and K1-paged-int8's device time (all kernels of a call)
    against the split length at three of phase 2's rows: the main row, the
    block_len 8 row and every row at 4095 (every split live); inputs
    cycled past L2."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    dev = torch.device("cuda")
    for bl, mb, pos_list, share in (
            (128, 32, [0, 4095, 17, 1000, 2047, 3000, 511, 128],
             ((1, 4, 16), (5, 3, 8))),
            (8, 512, [0, 7, 8, 255, 256, 257, 4095], ((5, 6, 32),)),
            (128, 32, [4095] * 8, ((0, 1, 16), (2, 3, 8)))):
        b = len(pos_list)
        tables, n_blocks, _ = paged_layout(pos_list, 1, bl, mb, share,
                                           seed=b)
        tables = torch.from_numpy(tables).to(dev)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        shape = (n_blocks, bl, 8, 128)
        n_sets = copies(2 * 2 * math.prod(shape))
        q = torch.randn((b, 1, 32, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16)

        def pool(int8):
            if int8:
                return torch.randint(-127, 128, shape, generator=gen,
                                     device=dev, dtype=torch.int8)
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        for name, int8 in (("decode_attention_paged", False),
                           ("decode_attention_paged_int8", True)):
            if int8:
                scales = [(0.002 + 0.02 * torch.rand(
                    n_blocks, 8, generator=gen, device=dev))
                    for _ in range(2)]
                fns = [lambda kp=pool(True), vp=pool(True):
                       da.decode_attention_paged_int8_cuda(
                           q, kp, vp, pos, tables, *scales)
                       for _ in range(n_sets)]
            else:
                fns = [lambda kp=pool(False), vp=pool(False):
                       da.decode_attention_paged_cuda(q, kp, vp, pos, tables)
                       for _ in range(n_sets)]
            sweep = split_sweep(torch, fns, (128, 256, 512, 1024))
            emit({"phase": "profile_k1_paged_split", "kernel": name,
                  "shape": f"B={b} s=1 Hq=32 Hkv=8 D=128 block_len={bl} "
                           f"max_blocks={mb} pos={pos_list} shared="
                           f"{[list(x) for x in share]}",
                  "device_us_by_split_len": sweep})
            del fns


def contiguous_split_sweep(torch, gen):
    """K1's and K1-int8's device time (all kernels of a call) against the
    split length at two of phase 2's rows: the main row and every row at
    4095 (every split live); inputs cycled past L2."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    dev = torch.device("cuda")
    b, L, n_gran = 8, 4096, 32
    shape = (b, L, 8, 128)
    for pos_list in ([0, 4095, 17, 1000, 2047, 3000, 511, 128], [4095] * 8):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        q = torch.randn((b, 1, 32, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        for name, int8 in (("decode_attention", False),
                           ("decode_attention_int8", True)):
            n_sets = copies(2 * (1 if int8 else 2) * math.prod(shape))
            if int8:
                fns = [lambda kc=torch.randint(
                           -127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8),
                       vc=torch.randint(-127, 128, shape, generator=gen,
                                        device=dev, dtype=torch.int8),
                       ks=0.002 + 0.02 * torch.rand(
                           b, n_gran, 8, generator=gen, device=dev),
                       vs=0.002 + 0.02 * torch.rand(
                           b, n_gran, 8, generator=gen, device=dev):
                       da.decode_attention_int8_cuda(q, kc, vc, pos, ks, vs)
                       for _ in range(n_sets)]
            else:
                fns = [lambda kc=torch.randn(shape, generator=gen, device=dev,
                                             dtype=torch.bfloat16),
                       vc=torch.randn(shape, generator=gen, device=dev,
                                      dtype=torch.bfloat16):
                       da.decode_attention_cuda(q, kc, vc, pos)
                       for _ in range(n_sets)]
            sweep = split_sweep(torch, fns, (64, 128, 256, 512, 1024, 4096))
            emit({"phase": "profile_k1_split", "kernel": name,
                  "shape": f"B={b} s=1 L={L} Hq=32 Hkv=8 D=128 "
                           f"pos={pos_list}"
                           + (f" granule={L // n_gran}" if int8 else ""),
                  "device_us_by_split_len": sweep})
            del fns


def phase_profile(torch, model, qmodel):
    """K1's and K1-int8's device time against the split length at two
    phase-2 rows, K1-paged's and K1-paged-int8's at three, then
    torch.profiler over a few decode ticks of 8 busy slots of each serving
    engine (speculative ones included), graphed and then its eager
    twin."""
    from paddle_tpu_torch.serving import ServingEngine, disable_graphs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    contiguous_split_sweep(torch, gen)
    paged_split_sweep(torch, gen)

    # decode ticks of 8 busy slots: the contiguous engine on phase 4's
    # prompts, then phase 4d's int8 engine on them, then the paged engine
    # on phase 4b's, then phase 4c's int8 engine on them, then phase 4e's
    # chunked engine (its ticks carry chunks while prompts stream in);
    # each window on the graphed engine and then on its eager twin
    # (disable_graphs())
    paged_kw = dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS)
    int8_kw = dict(kv_cache_dtype="int8", int8_weights=True)
    for phase, m, kw, prompts in (
            ("profile", model, {}, serving_prompts(model.config.vocab_size)),
            ("profile_int8_contiguous", qmodel, int8_kw,
             serving_prompts(model.config.vocab_size)),
            ("profile_paged", model, paged_kw,
             paged_serving_prompts(model.config.vocab_size)),
            ("profile_int8_paged", qmodel, dict(paged_kw, **int8_kw),
             paged_serving_prompts(model.config.vocab_size)),
            ("profile_chunked", model, dict(chunked=True,
                                            prefill_chunk=256),
             serving_prompts(model.config.vocab_size)),
            # verify ticks (spec_k 4, the n-gram drafter): contiguous,
            # paged, int8 paged
            ("profile_spec", model, dict(spec_decode=True, spec_k=SPEC_K),
             serving_prompts(model.config.vocab_size)),
            ("profile_spec_paged", model, dict(paged_kw, spec_decode=True,
                                               spec_k=SPEC_K),
             paged_serving_prompts(model.config.vocab_size)),
            ("profile_spec_int8", qmodel, dict(paged_kw, **int8_kw,
                                               spec_decode=True,
                                               spec_k=SPEC_K),
             paged_serving_prompts(model.config.vocab_size))):
        for mode in ("graphed", "eager"):
            with (disable_graphs() if mode == "eager"
                  else contextlib.nullcontext()):
                eng = ServingEngine(m, num_slots=8, max_length=4096,
                                    prefill_batch=4, device="cuda", **kw)
            emit(profile_window(torch, eng, prompts, phase, mode))
            eng.drain()
            del eng
            torch.cuda.empty_cache()


def profile_window(torch, eng, prompts, phase, mode):
    """torch.profiler over 5 decode ticks of 8 busy slots of ``eng`` (after
    its admission waves and warm ticks), with CUDA events around the same
    ticks: wall and device time by kernel, busy share, the K1 family's
    time.  Where the profiler saw no kernel in the window (a graph replay
    it did not resolve), the kernel fields say "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=16)
    for _ in range(4):              # admission waves + warm decode ticks
        eng.step()
    mixed = eng.metrics().get("mixed_ticks", 0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(5):
            eng.step()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    total = sum(t for t, _, _ in rows) / 1e3
    host = sorted((ev.self_cpu_time_total, ev.key, ev.count)
                  for ev in prof.key_averages()
                  if ev.key and ev.key.startswith("aten::"))[::-1]
    seen = bool(rows)
    return {"phase": phase, "mode": mode, "graphed": eng.graphed,
            "ticks": 5, "active_slots": eng.num_active,
            "mixed_ticks": eng.metrics().get("mixed_ticks", 0) - mixed,
            "wall_ms": round(wall_ms, 3),
            "events_ms": round(start.elapsed_time(end), 3),
            "device_kernel_ms": round(total, 3) if seen else "not measured",
            # the decode-attention kernels of the window (K1's family)
            "decode_attention_ms": round(sum(
                t for t, k, _ in rows if "decode_" in k) / 1e3, 3)
            if seen else "not measured",
            # the flash kernels of the window (K2's family: the paged
            # verify window, the chunk)
            "flash_attention_ms": round(sum(
                t for t, k, _ in rows if "flash_attention" in k) / 1e3, 3)
            if seen else "not measured",
            "device_busy_share": round(total / wall_ms, 4) if seen
            else "not measured",
            "top": [{"kernel": k[:90], "ms": round(t / 1e3, 3),
                     "calls": c} for t, k, c in rows[:15]],
            "host_self_top": [{"op": k, "ms": round(t / 1e3, 3),
                               "calls": c} for t, k, c in host[:15]]}


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


def grad_gate(torch, model, make_f32, loss_of, phase: str, fields):
    """Gate (a) of the training phases: step-1 gradients of
    ``loss_of(model)`` on the kernel path and on the plain path
    (``reference_mode()``), each against the float32 truth (``make_f32()``:
    the same weights in float32, on the plain path; built first and freed
    before the bf16 paths run).  The kernel path's relative L2 error,
    summed over every tensor, must be within 1.2x the plain path's, and
    tensor by tensor within 1.2x + GRAD_TENSOR_FLOOR, so a wrong dq or dk
    / dv of one projection cannot hide under the embeddings' share of the
    sum.  A one-element tensor (one sum over the batch) is held at
    GRAD_SCALAR_TOL instead.  Emits a ``phase`` line (``fields``
    first)."""
    from paddle_tpu_torch.ops._dispatch import reference_mode

    def grads(m):
        loss = loss_of(m)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(m.parameters()))

    model32 = make_f32()
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
    scalar = [p.numel() == 1 for p in model.parameters()]
    rel_k = math.sqrt(sum(err_k) / sum(truth_sq))
    rel_p = math.sqrt(sum(err_p) / sum(truth_sq))
    per_k = [math.sqrt(e / max(t, 1e-30)) for e, t in zip(err_k, truth_sq)]
    per_p = [math.sqrt(e / max(t, 1e-30)) for e, t in zip(err_p, truth_sq)]
    tensors = [i for i in range(len(names)) if not scalar[i]]
    worst = max(tensors, key=lambda i: per_k[i] / max(per_p[i], 1e-30))
    scalars = {names[i]: {"kernel": per_k[i], "plain": per_p[i]}
               for i in range(len(names)) if scalar[i]}
    tol = 1.2 * rel_p
    emit({"phase": phase, **fields,
          "loss_kernel": loss_k, "loss_plain": loss_p, "loss_f32": loss32,
          "grad_rel_l2_kernel_vs_f32": rel_k,
          "grad_rel_l2_plain_vs_f32": rel_p, "tol_kernel_vs_f32": tol,
          "max_tensor_rel_l2_kernel": max(per_k),
          "max_tensor_rel_l2_plain": max(per_p),
          "worst_tensor_ratio": {"name": names[worst],
                                 "kernel": per_k[worst],
                                 "plain": per_p[worst]},
          **({"one_element_tensors": scalars,
              "tol_one_element": GRAD_SCALAR_TOL} if scalars else {})})
    check(all(math.isfinite(x) for x in (loss_k, loss_p, rel_k)),
          f"{phase}: gradients are not finite")
    check(rel_k <= tol,
          f"{phase}: kernel-path gradients are {rel_k} from the float32 "
          f"truth, the plain path's {rel_p} (tolerance {tol})")
    bad = {names[i]: (per_k[i], per_p[i]) for i in tensors
           if per_k[i] > 1.2 * per_p[i] + GRAD_TENSOR_FLOOR}
    check(not bad, f"{phase}: gradients beyond 1.2x the plain path's error "
                   f"+ {GRAD_TENSOR_FLOOR}: {bad}")
    bad = {n: e for n, e in scalars.items()
           if not e["kernel"] <= GRAD_SCALAR_TOL}
    check(not bad, f"{phase}: one-element gradients beyond "
                   f"{GRAD_SCALAR_TOL}: {bad}")


def tiny_card_vs_cpu(torch, base, batches, dev):
    """Four steps of a float32 model's train step (:func:`_train_tiny`) on
    the card (kernels) and on the CPU (plain versions) from ``base``'s
    weights and the same numpy ``batches``.  Losses must agree to rtol 1e-5
    (float32 sum order); the parameters' difference (L2) within 1e-3 of
    the 4 steps' update -- Adam normalises each element by its own RMS, so
    where two steps' gradients nearly cancel, sum-order noise reaches
    single elements at a few percent of lr, while a wrong kernel moves the
    whole update (:func:`check_tiny`).  Returns the fields of the line,
    with the card run's launches and routes."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _dispatch
    init = {k: p.detach().clone() for k, p in base.named_parameters()}
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    card_l, card_p = _train_tiny(torch, copy.deepcopy(base).to(dev), batches,
                                 dev)
    launches = ops.launch_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    cpu_l, cpu_p = _train_tiny(torch, copy.deepcopy(base), batches,
                               torch.device("cpu"))
    diff = math.sqrt(sum(float((card_p[k] - cpu_p[k]).pow(2).sum())
                         for k in cpu_p))
    upd = math.sqrt(sum(float((cpu_p[k] - init[k]).pow(2).sum())
                        for k in cpu_p))
    max_abs = max(float((card_p[k] - cpu_p[k]).abs().max()) for k in cpu_p)
    return {"losses_card": card_l, "losses_cpu": cpu_l,
            "param_diff_l2": diff, "update_l2": upd,
            "param_max_abs_diff": max_abs, "launches": launches,
            "routes": routes}


def check_tiny(res, what: str) -> None:
    """:func:`tiny_card_vs_cpu`'s tolerances."""
    card_l, cpu_l = res["losses_card"], res["losses_cpu"]
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(card_l, cpu_l)),
          f"{what}: losses differ card vs cpu: {card_l} vs {cpu_l}")
    check(res["param_diff_l2"] <= 1e-3 * res["update_l2"],
          f"{what}: parameters differ card vs cpu: {res['param_diff_l2']} "
          f"against an update of {res['update_l2']}")


def phase_training(torch, kernels, profile: bool = False):
    """Phase 5: the single-GPU train step at the Llama-3-8B width, cut to
    TRAIN_LAYERS layers, recompute on, packed batches."""
    import numpy as np
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama3_8b_config,
                                         tiny_llama_config)
    from paddle_tpu_torch.ops import _dispatch
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

    # (a) step-1 gradients of one micro-batch against the float32 truth
    def llama32():
        m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                               device=dev)
        with torch.no_grad():
            for p32, p in zip(m32.parameters(), model.parameters()):
                p32.copy_(p)
        return m32

    grad_gate(torch, model, llama32, lambda m: m.compute_loss(**micro),
              "training_grads",
              {"config": "llama3_8b", "layers": TRAIN_LAYERS,
               "params": n_params, "init_s": round(init_s, 3),
               "micro_batch": list(micro["input_ids"].shape),
               "documents": len(torch_counts(micro["segment_ids"]))})

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
    # CPU (plain versions) from the same weights (:func:`tiny_card_vs_cpu`),
    # unpacked and packed batches (the dryrun's (8, 17) ids)
    tiny = tiny_llama_config(recompute=True)
    base = LlamaForCausalLM(tiny, device="cpu", seed=3)
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
        res = tiny_card_vs_cpu(torch, base, batches, dev)
        launches = res.pop("launches")
        del res["routes"]
        emit({"phase": "training_tiny_f32", "packed": packed, **res,
              "launches": {k: launches[k] for k in (
                  "flash_attention_fwd", *TRAIN_KERNELS)}})
        check_tiny(res, f"training_tiny_f32 packed={packed}")
        check(all(launches[k] > 0 for k in TRAIN_KERNELS),
              "the tiny train step ran no backward kernel")


def _dit_perturbed(torch, cfg, device, seed=0):
    """A DiT at ``cfg`` with seeded random weights (the reference's init),
    its AdaLN modulations and final layer then drawn N(0, 0.02) too: at
    AdaLN-Zero every gate is 0 and attention would never reach the
    output."""
    from paddle_tpu_torch.models import DiT
    m = DiT(cfg, device=device, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    with torch.no_grad():
        for n, prm in m.named_parameters():
            if n.rsplit(".", 1)[-1] in ("ada", "ada_b") or n.startswith(
                    "final."):
                prm.normal_(0.0, 0.02, generator=gen)
    return m


def phase_dit(torch, kernels, card, profile: bool = False):
    """DiT-XL/2 class-conditional DDIM sampling at the published width (28
    blocks, hidden 1152, 16 heads of 72, 32 x 32 x 4 latents in 2 x 2
    patches, 1000 classes, learn_sigma), bf16, seeded weights off
    AdaLN-Zero (:func:`_dit_perturbed`).  Gates: (a) one forward at B 16
    (8 labels + 8 null), the kernel path's relative L2 error against a
    float32 copy (plain path) within 1.2x the plain path's; (b)
    ``ddim_sample`` of 8 labels, 50 steps, guidance 4, eta 0, seeded
    ``x_init``: its key built once (the step captured as one CUDA graph)
    and replayed 50 times a sample, K2 28 x 50 launches a sample, no
    plain route, every latent finite, and the latents equal to its eager
    twin's (``disable_graphs()``) bit for bit; (c) the tiny float32 DiT
    (head_dim 16) and a narrow float32 one at head_dim 72 (hidden 144, 2
    heads, depth 2), 8-step guided samples on the card (kernels) against
    the CPU (plain) from the same weights and ``x_init``.  Reported:
    sampling ms, latents/s, ms a step, K2's share of a step (phase 2's
    main-row time x 28), peak memory, the card."""
    from paddle_tpu_torch.models import (dit_xl_2_config, ddim_sample,
                                         tiny_dit_config)
    from paddle_tpu_torch.ops import (_dispatch, launch_counts,
                                      reset_launch_counts)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.serving import disable_graphs

    dev = torch.device("cuda")
    # what earlier phases still hold counts in the peak: report it beside
    allocated_before = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dit_xl_2_config(dtype="bfloat16")
    m = _dit_perturbed(torch, cfg, dev)
    m.eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(cfg.depth == DIT_DEPTH and cfg.num_heads == DIT_HEADS
          and cfg.head_dim == DIT_HEAD_DIM
          and cfg.num_patches == DIT_TOKENS, f"DiT-XL/2 config: {cfg}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    shape = (DIT_LABELS, cfg.in_channels, cfg.input_size, cfg.input_size)

    # (a) one forward: kernels, plain, float32 truth
    labels = torch.randint(0, cfg.num_classes, (DIT_LABELS,), generator=gen,
                           device=dev)
    y = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
    x = torch.randn((DIT_BATCH, *shape[1:]), generator=gen, device=dev)
    t = torch.randint(0, 1000, (DIT_BATCH,), generator=gen, device=dev)
    with torch.no_grad():
        got = m(x, t, y).float()
        with reference_mode():
            plain = m(x, t, y).float()
            m32 = copy.deepcopy(m).float()
            truth = m32(x, t, y).float()
    del m32
    torch.cuda.empty_cache()

    def rel(a):
        return float((a - truth).norm() / truth.norm())

    fwd = {"kernel_rel_l2": rel(got), "plain_rel_l2": rel(plain),
           "kernel_vs_plain_max_abs": max_err(got, plain),
           "finite": bool(torch.isfinite(got).all().item())}
    check(fwd["finite"] and fwd["kernel_rel_l2"] <= 1.2 * fwd["plain_rel_l2"],
          f"dit forward: kernel path error {fwd['kernel_rel_l2']} beyond "
          f"1.2x the plain path's {fwd['plain_rel_l2']}")
    del got, plain, truth

    # (b) graphed sampling: a cold call (the build), a warm call, the twin
    x_init = torch.randn(shape, generator=gen, device=dev)
    kw = dict(steps=DIT_STEPS, cfg_scale=DIT_CFG, eta=0.0, x_init=x_init)
    key = (DIT_LABELS, DIT_STEPS, DIT_CFG, 0.0, 1000, False)

    def sample():
        reset_launch_counts()
        _dispatch.reset_kernel_paths()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ddim_sample(m, labels, **kw)
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t1) * 1e3,
                "launches": {k: n for k, n in launch_counts().items() if n},
                "routes": {f"{op}/{path}": n for (op, path), n in
                           _dispatch.kernel_paths.items()}, "out": out}

    cold = sample()
    sampler = m._ddim_jit_cache[key]
    warm = sample()
    graphs = {"traces": sampler.traces, "graphed": sampler.graphed,
              "replays": sampler.replays}
    own_cache = m._ddim_jit_cache
    m._ddim_jit_cache = {}
    prof_rows = None
    with disable_graphs():
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
                twin = sample()
            prof_rows = kernel_rows(prof)
        else:
            twin = sample()
    twin_traces = m._ddim_jit_cache[key].traces
    m._ddim_jit_cache = own_cache
    k2_want = DIT_DEPTH * DIT_STEPS
    run = {k: warm[k] for k in ("ms", "launches", "routes")}
    run.update(cold_ms=cold["ms"], eager_ms=twin["ms"],
               ms_per_step=warm["ms"] / DIT_STEPS,
               latents_per_s=DIT_LABELS / (warm["ms"] / 1e3),
               eager_ms_per_step=twin["ms"] / DIT_STEPS,
               twin_identical=bool(torch.equal(warm["out"], twin["out"])),
               twin_max_abs=max_err(warm["out"], twin["out"]),
               cold_identical=bool(torch.equal(warm["out"], cold["out"])),
               twin_launches_identical=twin["launches"] == warm["launches"],
               twin_traces=twin_traces,
               finite=bool(torch.isfinite(warm["out"]).all().item()),
               latent_abs_max=float(warm["out"].abs().max()), **graphs)
    k2_row = kernels.get("flash_attention_fwd/d72", {})
    if k2_row.get("ms"):
        run["k2_ms_per_step"] = k2_row["ms"] * DIT_DEPTH
        run["k2_share_of_step"] = (k2_row["ms"] * DIT_DEPTH
                                   / run["ms_per_step"])
    if prof_rows is not None:
        total = sum(us for us, _, _ in prof_rows)
        k2 = sum(us for us, n, _ in prof_rows if "flash_attention_fwd" in n)
        gemm = sum(us for us, n, _ in prof_rows
                   if re.search(r"gemm|xmma|nvjet|cutlass", n))
        run["profile_eager"] = {
            "kernel_ms_per_step": total / 1e3 / DIT_STEPS,
            "k2_ms_per_step": k2 / 1e3 / DIT_STEPS,
            "gemm_ms_per_step": gemm / 1e3 / DIT_STEPS,
            "other_ms_per_step": (total - k2 - gemm) / 1e3 / DIT_STEPS,
            "top": [[n[:80], round(us / 1e3 / DIT_STEPS, 5), c]
                    for us, n, c in prof_rows[:8]]}
    run["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    run["allocated_before_phase_gb"] = allocated_before
    emit({"phase": "dit", "card": card, "init_s": init_s,
          "config": dataclasses.asdict(cfg), "labels": labels.tolist(),
          "forward": fwd, "sampling": run})
    check(graphs == {"traces": 1, "graphed": True,
                     "replays": 2 * DIT_STEPS} and twin_traces == 1,
          f"dit sampling: one build and {DIT_STEPS} replays a sample "
          f"expected, got {graphs}, twin builds {twin_traces}")
    for tag, r in (("cold", cold), ("warm", warm), ("eager twin", twin)):
        check(r["launches"].get("flash_attention_fwd") == k2_want,
              f"dit sampling ({tag}): K2 launches "
              f"{r['launches'].get('flash_attention_fwd')} != {k2_want}")
        check(not any(k.endswith("/plain") for k in r["routes"]),
              f"dit sampling ({tag}): a plain route {r['routes']}")
    check(run["finite"], "dit sampling: a latent is not finite")
    check(run["twin_identical"] and run["cold_identical"],
          f"dit sampling: graphed latents differ from the eager twin's "
          f"(max {run['twin_max_abs']}) or from the cold call's")
    kernels["flash_attention_fwd/d72"]["launches"] = \
        warm["launches"]["flash_attention_fwd"]

    # ROADMAP C2: the sampler's graph after a dtype round trip of the
    # weights, which gives every parameter new storage; the copy is made
    # after it, so it takes the freed blocks
    ptrs = [p.data_ptr() for p in m.parameters()]
    m.float()
    m.to(torch.bfloat16)
    moved = ptrs != [p.data_ptr() for p in m.parameters()]
    fresh = copy.deepcopy(m)
    with torch.no_grad():
        after = ddim_sample(m, labels, **kw)
        want_c2 = ddim_sample(fresh, labels, **kw)
    c2 = {"storage_moved": moved,
          "equal_to_fresh_copy": bool(torch.equal(after, want_c2)),
          "equal_to_before": bool(torch.equal(after, warm["out"])),
          "samplers": len(m._ddim_jit_cache)}
    emit({"phase": "dit_c2", **c2})
    check(moved and c2["equal_to_fresh_copy"] and c2["equal_to_before"],
          f"dit C2: after a dtype round trip the latents differ ({c2})")
    del m, cold, warm, twin, sampler, own_cache, fresh, after, want_c2
    gc.collect()
    torch.cuda.empty_cache()

    # (c) tiny float32 DiTs: card (kernels) against the CPU (plain)
    for name, kw_cfg in (("tiny", {}),
                         ("d72", dict(hidden_size=144, num_heads=2))):
        cpu = _dit_perturbed(torch, tiny_dit_config(**kw_cfg), "cpu")
        card_m = copy.deepcopy(cpu).to(dev)
        g = torch.Generator().manual_seed(3)
        xi = torch.randn((4, 4, 8, 8), generator=g)
        ys = [0, 3, 7, 9]
        reset_launch_counts()
        _dispatch.reset_kernel_paths()
        on_card = ddim_sample(card_m, ys, steps=8, cfg_scale=DIT_CFG,
                              x_init=xi.to(dev)).cpu()
        launches = launch_counts()["flash_attention_fwd"]
        card_paths = dict(_dispatch.kernel_paths)
        on_cpu = ddim_sample(cpu, ys, steps=8, cfg_scale=DIT_CFG, x_init=xi)
        diff = max_err(on_card, on_cpu)
        scale = float(on_cpu.abs().max())
        sampler = card_m._ddim_jit_cache[(4, 8, DIT_CFG, 0.0, 1000, False)]
        emit({"phase": "dit_tiny_f32", "model": name,
              "head_dim": card_m.config.head_dim, "max_abs_diff": diff,
              "latent_abs_max": scale, "tol": "1e-5 x the largest |latent|",
              "k2_launches": launches, "graphed": sampler.graphed,
              "traces": sampler.traces})
        check(diff <= 1e-5 * scale,
              f"dit_tiny_f32 {name}: card and CPU latents differ by {diff} "
              f"(largest {scale})")
        check(launches == card_m.config.depth * 8 and sampler.graphed
              and card_paths.get(("flash_attention", "plain"), 0) == 0,
              f"dit_tiny_f32 {name}: K2 {launches} launches, graphed "
              f"{sampler.graphed}, routes {card_paths}")
        del cpu, card_m


def dit_batch(cfg, n: int, seed: int):
    """A seeded DiT training batch (numpy), built as the reference's test
    builds it (``tests/test_breadth_models.py:320-328``): x0 and the noise
    N(0, 1) latents, t uniform in [0, T), ``x = sqrt(abar_t) x0 + sqrt(1 -
    abar_t) noise`` with abar from the port's ``diffusion_schedule``, the
    target the noise; labels uniform over the classes, ``round(
    DIT_LABEL_DROP * n)`` of them (at least one) the null class -- the
    paper's label dropout for guidance, applied as data."""
    import numpy as np
    from paddle_tpu_torch.models import diffusion_schedule
    rng = np.random.RandomState(seed)
    shape = (n, cfg.in_channels, cfg.input_size, cfg.input_size)
    x0 = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    abar = diffusion_schedule().numpy()
    t = rng.randint(0, len(abar), n).astype(np.int64)
    y = rng.randint(0, cfg.num_classes, n).astype(np.int64)
    y[rng.permutation(n)[:max(1, round(DIT_LABEL_DROP * n))]] = \
        cfg.num_classes
    a = abar[t][:, None, None, None]
    return {"x": (np.sqrt(a) * x0 + np.sqrt(1 - a) * noise).astype(
                np.float32),
            "t": t, "y": y, "target": noise}


def dit_train_flops(cfg, batch: int) -> int:
    """Model FLOPs of one DiT train step, counted from the shapes at 2
    FLOPs a multiply-add, the backward twice the forward (6 a multiply-add
    in all): a token's products in every block (qkv, proj and the MLP:
    (4 + 2 mlp_ratio) h^2), its patch embedding and final projection; a
    latent's AdaLN products (6 h^2 a block, 2 h^2 final) and timestep MLP;
    a latent's attention, Q K^T and P V over its N patch tokens (2 N^2 h a
    block).  LayerNorm, GELU, modulation and the loss are not counted."""
    h, n = cfg.hidden_size, cfg.num_patches
    p2 = cfg.patch_size ** 2
    per_token = (cfg.depth * (4 * h * h + 2 * h * int(h * cfg.mlp_ratio))
                 + p2 * cfg.in_channels * h + h * p2 * cfg.out_channels)
    per_latent = (cfg.depth * 6 * h * h + 2 * h * h + 256 * h + h * h
                  + cfg.depth * 2 * n * n * h)
    return 6 * (batch * n * per_token + batch * per_latent)


@contextlib.contextmanager
def recording_backward(calls):
    """K5 / K6 as ``FlashAttention.backward`` calls them: the first and the
    latest call of each wrapper kept as (wrapper, args, kwargs, outputs) in
    ``calls[name]``, so :func:`same_bits` can launch them again."""
    from paddle_tpu_torch.ops import attention
    names = ("flash_attention_bwd_dq_cuda", "flash_attention_bwd_dkv_cuda")
    saved = {n: getattr(attention, n) for n in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            entry = (fn, args, kwargs, out)
            calls.setdefault(name, [entry, entry])[1] = entry
            return out
        return call

    for n, fn in saved.items():
        setattr(attention, n, recorder(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(attention, n, fn)


def same_bits(torch, calls):
    """{wrapper: whether every recorded call, launched again on its own
    inputs, gives its outputs bit for bit} (these launches are not the
    run's: read the counts first)."""
    out = {}
    for name, entries in calls.items():
        ok = True
        for fn, args, kwargs, got in entries:
            again = fn(*args, **kwargs)
            pairs = zip(got, again) if isinstance(got, tuple) else \
                [(got, again)]
            ok = ok and all(torch.equal(a, b) for a, b in pairs)
        out[name] = ok
    return out


def phase_dit_train(torch, kernels, card, profile: bool = False):
    """DiT-XL/2 training at the published width, not cut (28 blocks,
    hidden 1152, 16 heads of 72, 32 x 32 x 4 latents in 2 x 2 patches,
    1000 classes + null, learn_sigma), bf16, seeded weights off AdaLN-Zero
    (:func:`_dit_perturbed`), ``build_train_step`` with the DiT paper's
    AdamW (lr 1e-4, betas (0.9, 0.999), weight decay 0), 32 latents a
    step (:func:`dit_batch`).  Gates: (a) step-1 gradients of a
    micro-batch of 8, the kernel path within 1.2x the plain path's error
    against a float32 copy (:func:`grad_gate`); (b) 8 steps
    (``recompute=False``): every loss finite, K2 = K5 = K6 = 28 launches
    a step and no other kernel, no plain route, the first and the last K5
    / K6 call of a step the same bits when launched again, and with
    ``recompute=True`` a micro-batch's gradients take K2 2 x 28, K5 = K6 =
    28; (c) the tiny float32 DiT (head_dim 16) and the narrow one at 72
    (hidden 144, 2 heads, depth 2): 4 train steps on the card against the
    CPU (:func:`tiny_card_vs_cpu`).  Reported: step ms p50 over steps 3-8,
    latents/s, tokens/s, the model-FLOPs share of 989 TFLOP/s
    (:func:`dit_train_flops`), peak memory, K5 + K6's share of a step
    (phase 2's main-row times x 28); with ``--profile`` one step's kernel
    time by class and the optimizer's device time."""
    import numpy as np
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import dit_xl_2_config, tiny_dit_config
    from paddle_tpu_torch.ops import (_dispatch, launch_counts,
                                      reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW

    dev = torch.device("cuda")
    allocated_before = torch.cuda.memory_allocated() / 1e9
    cfg = dit_xl_2_config(dtype="bfloat16")
    t0 = time.perf_counter()
    m = _dit_perturbed(torch, cfg, dev)
    m.train()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in m.parameters())

    def on_card(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    # (a) step-1 gradients of a micro-batch against the float32 truth
    micro = on_card(dit_batch(cfg, DIT_GRAD_BATCH, seed=100))
    grad_gate(torch, m, lambda: copy.deepcopy(m).float(),
              lambda mod: mod.compute_loss(**micro), "dit_train_grads",
              {"config": "dit_xl_2", "params": n_params,
               "init_s": round(init_s, 3),
               "micro_batch": list(micro["x"].shape),
               "null_labels": int((micro["y"] == cfg.num_classes).sum())})

    # (b) DIT_TRAIN_STEPS steps, a fresh batch each; every launch and
    # route counter reset just before and read just after; K5 / K6's
    # first and last call of step 1 recorded, launched again afterwards
    opt = AdamW(DIT_TRAIN_LR, beta1=0.9, beta2=0.999, weight_decay=0.0)
    step = build_train_step(m, opt)
    batches = [on_card(dit_batch(cfg, DIT_TRAIN_BATCH, seed=200 + i))
               for i in range(DIT_TRAIN_STEPS)]
    calls, losses, step_ms = {}, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _dispatch.reset_kernel_paths()
    for i, batch in enumerate(batches):
        with (recording_backward(calls) if i == 0
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))      # float() synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: n for k, n in launch_counts().items() if n}
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = same_bits(torch, calls)
    del calls

    # recompute=True: a micro-batch's gradients rerun each block's forward
    cfg.recompute = True
    reset_launch_counts()
    torch.autograd.grad(m.compute_loss(**micro), list(m.parameters()))
    recompute_launches = {k: n for k, n in launch_counts().items() if n}
    cfg.recompute = False

    timed = step_ms[DIT_TRAIN_UNTIMED:]
    p50 = float(np.median(timed))
    tokens = DIT_TRAIN_BATCH * cfg.num_patches
    flops = dit_train_flops(cfg, DIT_TRAIN_BATCH)
    run = {"losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
           "timed_steps": len(timed),
           "latents_per_s": DIT_TRAIN_BATCH / (p50 / 1e3),
           "tokens_per_s": tokens / (p50 / 1e3),
           "model_flops_per_step": flops,
           "model_flops_share_of_989T": flops / (p50 / 1e3) / BF16_FLOPS,
           "peak_allocated_gb": peak_gb,
           "allocated_before_phase_gb": allocated_before,
           "launches": launches, "routes": routes,
           "k5_k6_same_bits": same,
           "recompute_micro_batch_launches": recompute_launches,
           "null_labels": [int((b["y"] == cfg.num_classes).sum())
                           for b in batches]}
    bwd_rows = [kernels.get(n, {}).get("ms") for n in DIT_BWD]
    if all(bwd_rows):
        run["k5_k6_ms_per_step"] = sum(bwd_rows) * cfg.depth
        run["k5_k6_share_of_step"] = run["k5_k6_ms_per_step"] / p50
    emit({"phase": "dit_train", "card": card, "init_s": init_s,
          "config": dataclasses.asdict(cfg), "params": n_params,
          "optimizer": "AdamW(1e-4, beta1=0.9, beta2=0.999, "
                       "weight_decay=0.0)",
          "batch": [DIT_TRAIN_BATCH, cfg.in_channels, cfg.input_size,
                    cfg.input_size],
          "flops_note": "6 x multiply-adds of the products a step "
                        "(dit_train_flops)", **run})
    check(all(math.isfinite(x) for x in losses), f"dit_train losses {losses}")
    per_step = {"flash_attention_fwd": cfg.depth,
                "flash_attention_bwd_dq": cfg.depth,
                "flash_attention_bwd_dkv": cfg.depth}
    check(launches == {k: n * DIT_TRAIN_STEPS for k, n in per_step.items()},
          f"dit_train: launches {launches} in {DIT_TRAIN_STEPS} steps, "
          f"expected {per_step} a step and no other kernel")
    check(not any(k.endswith("/plain") for k in routes),
          f"dit_train: a plain route on the card {routes}")
    check(set(same) == {"flash_attention_bwd_dq_cuda",
                        "flash_attention_bwd_dkv_cuda"} and all(same.values()),
          f"dit_train: K5 / K6 not the same bits twice: {same}")
    check(recompute_launches == dict(per_step, flash_attention_fwd=2
                                     * cfg.depth),
          f"dit_train recompute: launches {recompute_launches}")
    for name, base in zip(DIT_BWD, TRAIN_KERNELS):
        kernels.setdefault(name, {})["launches"] = launches.get(base, 0)
    if profile:
        profile_step(torch, step, opt, batches[-1], "profile_dit_train")
    del step, opt, m, batches, micro
    gc.collect()
    torch.cuda.empty_cache()

    # (c) tiny float32 DiTs: 4 train steps on the card against the CPU
    for name, kw_cfg in (("tiny", {}),
                         ("d72", dict(hidden_size=144, num_heads=2))):
        tcfg = tiny_dit_config(**kw_cfg)
        base = _dit_perturbed(torch, tcfg, "cpu")
        res = tiny_card_vs_cpu(torch, base, [dit_batch(tcfg, 8, seed=300 + i)
                                             for i in range(4)], dev)
        launches = {k: n for k, n in res.pop("launches").items() if n}
        want = {k: tcfg.depth * 4 for k in per_step}
        emit({"phase": "dit_train_tiny_f32", "model": name,
              "head_dim": tcfg.head_dim, **res, "launches": launches})
        check_tiny(res, f"dit_train_tiny_f32 {name}")
        check(launches == want and not any(
                  k.endswith("/plain") for k in res["routes"]),
              f"dit_train_tiny_f32 {name}: launches {launches} (expected "
              f"{want}), routes {res['routes']}")


# -- generation and Qwen2-VL ---------------------------------------------------------

# generate: phase 3's Llama-3-8B model; greedy and sampled at B 4, prompt
# 128, 64 new tokens; beam search at B 2, K 4, 32 new tokens
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 64
GEN_SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.9, "seed": 5}
BEAM_BATCH, BEAM_K, BEAM_NEW = 2, 4, 32
# K3 launches of one Llama-3-8B pass: 2 a layer and the final norm
K3_PER_PASS_8B = 2 * LAYERS_8B + 1


def generation_run(torch, fn):
    """One ``generate`` call with every launch and route counter reset just
    before and read just after: wall ms (to the last token on the host),
    launches, K2 / K5 / K6 launches by (name, head_dim, Sq, Skv, causal)
    (the wrappers' ``.by_shape``, credited per replay in a graph), routes,
    the output."""
    from paddle_tpu_torch.ops import (_dispatch, launch_counts,
                                      reset_launch_counts, shape_counts)
    reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return {"ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: n for k, n in launch_counts().items() if n},
            "shapes": shape_counts(),
            "routes": {f"{op}/{path}": n for (op, path), n in
                       _dispatch.kernel_paths.items()}, "out": out}


def graphed_and_twin(torch, m, fn, what, want, new_tokens,
                     want_shapes=None):
    """``fn()`` (a ``generate`` call of ``m``) cold (its key's build),
    warm (replays only) and as its eager twin (the same key built inside
    ``disable_graphs()`` into a cache of its own).  Gates: one build,
    graphed, ``new_tokens - 1`` replays a call; the three outputs equal bit
    for bit; each run's launches equal ``want`` and, where given, its K2 /
    K5 / K6 launches by shape ``want_shapes``; no plain route.  Returns the
    fields of the line (tokens/s and ms a token: rows x new tokens over the
    warm call's wall time, prefill included), the warm (graphed) run's
    launches by shape, the output and the program."""
    from paddle_tpu_torch.serving import disable_graphs
    before = set(getattr(m, "_generate_jit_cache", None) or ())
    cold = generation_run(torch, fn)
    (key,) = set(m._generate_jit_cache) - before
    prog = m._generate_jit_cache[key]
    warm = generation_run(torch, fn)
    own = m._generate_jit_cache
    m._generate_jit_cache = {}
    try:
        with disable_graphs():
            twin = generation_run(torch, fn)
        twin_prog = m._generate_jit_cache[key]
    finally:
        m._generate_jit_cache = own
    b = warm["out"].shape[0]
    fields = {"ms": warm["ms"], "cold_ms": cold["ms"],
              "eager_ms": twin["ms"],
              "tokens_per_s": b * new_tokens / (warm["ms"] / 1e3),
              "ms_per_token": warm["ms"] / new_tokens,
              "eager_tokens_per_s": b * new_tokens / (twin["ms"] / 1e3),
              "launches": warm["launches"], "routes": warm["routes"],
              "traces": prog.traces, "graphed": prog.graphed,
              "replays": prog.replays, "twin_traces": twin_prog.traces,
              "twin_graphed": twin_prog.graphed,
              "twin_identical": bool(torch.equal(warm["out"], twin["out"])),
              "cold_identical": bool(torch.equal(warm["out"], cold["out"])),
              "twin_launches_identical": twin["launches"] == warm["launches"],
              "cold_launches_identical": cold["launches"] == warm["launches"]}
    check(prog.traces == 1 and prog.graphed
          and prog.replays == 2 * (new_tokens - 1)
          and twin_prog.traces == 1 and not twin_prog.graphed,
          f"{what}: one graphed build and {new_tokens - 1} replays a call "
          f"expected, got traces {prog.traces}, graphed {prog.graphed}, "
          f"replays {prog.replays}; twin {twin_prog.traces} / "
          f"{twin_prog.graphed}")
    check(fields["twin_identical"] and fields["cold_identical"],
          f"{what}: graphed tokens differ from the eager twin's or the cold "
          f"call's")
    for tag, r in (("cold", cold), ("warm", warm), ("eager twin", twin)):
        check(r["launches"] == want,
              f"{what} ({tag}): launches {r['launches']}, expected {want}")
        check(want_shapes is None or r["shapes"] == want_shapes,
              f"{what} ({tag}): launches by (D, Sq, Skv, causal) "
              f"{r['shapes']}, expected {want_shapes}")
        check(not any(k.endswith("/plain") for k in r["routes"]),
              f"{what} ({tag}): a plain route {r['routes']}")
    return fields, warm["shapes"], warm["out"], prog


def phase_generate(torch, model, qmodel, card):
    """Whole-sequence generation (``models.generation``) on phase 3's
    Llama-3-8B model, bf16, 32 layers: greedy (B 4, prompt 128, 64 new
    tokens), sampled (temperature 0.8, top_k 50, top_p 0.9), beam search
    (B 2, K 4, 32 new tokens, an EOS id) and greedy through the int8
    ``QuantizedForDecode`` (K4).  Each key is built once (the decode step
    captured as a CUDA graph, replayed for every token after the first)
    and run beside its eager twin: the same tokens bit for bit, the same
    launches -- K1 32 a decode step, K2 32 a prefill, K3 65 a pass, K4 7 x
    32 + 1 a decode step (int8; the 512-row prefill takes the dequant
    route) -- and no plain route.  Gate: the greedy run's first-step
    logits (the prefill's last position, kept by the program) within 1.2x
    the plain path's error against a float32 copy of the weights, as phase
    3 gates its logits.  Reported: tokens/s and ms a token, graphed and
    eager."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaForCausalLM, init_kv_cache)
    from paddle_tpu_torch.ops._dispatch import reference_mode

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = model.config
    rng = np.random.RandomState(16)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (
        GEN_BATCH, GEN_PROMPT)).astype(np.int32)).to(dev)
    steps = GEN_NEW - 1

    def want(new, int8=False):
        w = {"decode_attention": LAYERS_8B * (new - 1),
             "flash_attention_fwd": LAYERS_8B,
             "rms_norm": K3_PER_PASS_8B * new}
        if int8:
            w["int8_matmul"] = K4_PER_TICK * (new - 1)
        return w

    runs = {}
    greedy, _, out, prog = graphed_and_twin(
        torch, model, lambda: model.generate(ids, max_new_tokens=GEN_NEW),
        "generate greedy", want(GEN_NEW), GEN_NEW)
    runs["greedy"] = greedy
    first = prog.prefill_logits.float()

    # first-step logits: the kernel path (the graphed run's prefill)
    # against a float32 copy of the weights, beside the plain path
    def prefill(m):
        cache = init_kv_cache(m.config, GEN_BATCH, GEN_PROMPT, device=dev)
        with torch.no_grad():
            return m.decode_step(ids, cache, 0)[0][:, -1].float()

    with reference_mode():
        plain = prefill(model)
    model32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                               device=dev)
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    with reference_mode():
        truth = prefill(model32)
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    err_k, err_p = max_err(first, truth), max_err(plain, truth)
    gate = {"max_logit_err_kernel_vs_f32": err_k,
            "max_logit_err_plain_vs_f32": err_p,
            "max_abs_logit": float(truth.abs().max()),
            "tol_kernel_vs_f32": 1.2 * err_p,
            "finite": bool(torch.isfinite(first).all().item())}

    sampled, _, s_out, _ = graphed_and_twin(
        torch, model, lambda: model.generate(ids, max_new_tokens=GEN_NEW,
                                             **GEN_SAMPLING),
        "generate sampled", want(GEN_NEW), GEN_NEW)
    sampled["differs_from_greedy"] = not bool(torch.equal(s_out, out))
    runs["sampled"] = sampled

    # an EOS id the search meets: greedy's second token of row 0
    eos = int(out[0, GEN_PROMPT + 1])
    bids = ids[:BEAM_BATCH]
    beam, _, b_out, _ = graphed_and_twin(
        torch, model, lambda: model.generate(
            bids, max_new_tokens=BEAM_NEW, num_beams=BEAM_K,
            eos_token_id=eos, pad_token_id=0),
        "generate beam", want(BEAM_NEW), BEAM_NEW)
    beam["eos_token_id"] = eos
    beam["rows_with_eos"] = int((b_out[:, GEN_PROMPT:] == eos).any(1)
                                .sum().item())
    runs["beam"] = beam

    int8, _, _, _ = graphed_and_twin(
        torch, qmodel, lambda: qmodel.generate(ids, max_new_tokens=GEN_NEW),
        "generate int8", want(GEN_NEW, int8=True), GEN_NEW)
    runs["int8"] = int8
    for r in runs.values():
        r.pop("routes")
    emit({"phase": "generate", "card": card, "config": "llama3_8b",
          "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
          "sampling": GEN_SAMPLING,
          "beam_config": {"batch": BEAM_BATCH, "num_beams": BEAM_K,
                          "new_tokens": BEAM_NEW},
          "decode_steps": steps, "first_step_logits": gate, **runs})
    check(gate["finite"], "generate: first-step logits are not finite")
    check(err_k <= gate["tol_kernel_vs_f32"],
          f"generate: first-step logits are {err_k} from the float32 model, "
          f"the plain path's {err_p} (tolerance {gate['tol_kernel_vs_f32']})")


def _qwen_model(torch, cfg, device, seed=0):
    """A seeded Qwen2-VL with its cross gates at 0.5 (at init tanh(0) = 0
    keeps the image from the logits; a trained model's gates are open)."""
    from paddle_tpu_torch.models import Qwen2VLForConditionalGeneration
    m = Qwen2VLForConditionalGeneration(cfg, device=device, seed=seed)
    with torch.no_grad():
        for c in m.cross:
            c.gate.fill_(0.5)
    return m


def qwen_inputs(torch, cfg, b, s, seed):
    """Seeded (ids (B, s) int64, pixels (B, C, H, W) float32), numpy."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int64),
            rng.standard_normal((b, cfg.in_channels, cfg.image_size,
                                 cfg.image_size)).astype(np.float32))


def phase_qwen2_vl(torch, kernels, card):
    """Qwen2-VL at its default widths (``Qwen2VLConfig()``: 224 x 224
    images in 256 patches, a 2-block tower of 4 heads of 64, a 4-layer
    decoder of 8 heads of 128 with a cross layer after every 2nd, vocab
    32000), bf16, seeded weights with the cross gates at 0.5.  Gates: (a)
    the forward logits of 4 images and 64-token prompts, and the logits of
    greedy generation's first decode step (K1 at one query head a KV
    head), the kernel path within 1.2x the plain path's error against a
    float32 copy; (b) greedy and beam-4 ``generate`` of 32 new tokens, each
    built once, graphed and equal bit for bit to its eager twin, with exact
    launches: K2 at D 64 2 (the tower), causal at D 128 4 (the prefill),
    not causal at D 128 over the 256 patches 2 x 32 (the cross layers: Sq
    64 at the prefill, Sq 1 at each of the 31 decode steps; by shape in
    every run, replays included), K1 4 x 31,
    K3 11 x 32; (c) ROADMAP C2 for the generation graph: generate, convert
    the model to float32 and back, generate again, equal to a fresh copy's
    tokens; (d) the tiny float32 model, greedy and beam, card against the
    CPU, tokens identical."""
    from paddle_tpu_torch.models import (Qwen2VLConfig, init_kv_cache,
                                         tiny_qwen2_vl_config)
    from paddle_tpu_torch.ops._dispatch import reference_mode

    dev = torch.device("cuda")
    cfg = Qwen2VLConfig(dtype="bfloat16")
    t0 = time.perf_counter()
    m = _qwen_model(torch, cfg, dev)
    m.eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids_np, pix_np = qwen_inputs(torch, cfg, QWEN_BATCH, QWEN_PROMPT, 16)
    ids, pix = torch.from_numpy(ids_np).to(dev), torch.from_numpy(pix_np).to(
        dev)

    # (a) logits against a float32 copy: the forward, and greedy
    # generation's first decode step (the prompt at pos=0, then the greedy
    # token at per-row positions: K1 at one query head a KV head on the
    # card), each path over its own vision features and cache
    def first_decode(mod):
        vision = mod.visual(pix)
        cache = init_kv_cache(mod.config, QWEN_BATCH, QWEN_PROMPT + QWEN_NEW,
                              dtype=mod.dtype, device=dev)
        cache = mod.decode_step(ids, cache, 0, vision)[1]
        pos = torch.full((QWEN_BATCH,), QWEN_PROMPT, dtype=torch.int32,
                         device=dev)
        return mod.decode_step(tok, cache, pos, vision)[0][:, -1].float()

    with torch.no_grad():
        got = m(ids, pix).float()
        tok = got[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        got_d = first_decode(m)
        with reference_mode():
            plain = m(ids, pix).float()
            plain_d = first_decode(m)
            m32 = copy.deepcopy(m).float()
            truth = m32(ids, pix)
            truth_d = first_decode(m32)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    gates = {}
    for tag, (k_, p_, t_) in (("forward", (got, plain, truth)),
                              ("first_decode_step", (got_d, plain_d,
                                                     truth_d))):
        gates[tag] = {"max_logit_err_kernel_vs_f32": max_err(k_, t_),
                      "max_logit_err_plain_vs_f32": max_err(p_, t_),
                      "max_abs_logit": float(t_.abs().max()),
                      "tol_kernel_vs_f32": 1.2 * max_err(p_, t_),
                      "finite": bool(torch.isfinite(k_).all().item())}
    del got, plain, truth, got_d, plain_d, truth_d

    # (b) greedy and beam search, graphed beside the eager twin
    layers, n_cross = cfg.num_hidden_layers, len(m.cross)
    k3 = 2 * layers + n_cross + 1
    want = {"flash_attention_fwd": cfg.vision_layers + layers
            + n_cross * QWEN_NEW,
            "decode_attention": layers * (QWEN_NEW - 1),
            "rms_norm": k3 * QWEN_NEW}
    want_shapes = {
        ("flash_attention_fwd", 64, QWEN_PATCHES, QWEN_PATCHES, False):
            cfg.vision_layers,
        ("flash_attention_fwd", 128, QWEN_PROMPT, QWEN_PROMPT, True): layers,
        ("flash_attention_fwd", 128, QWEN_PROMPT, QWEN_PATCHES, False):
            n_cross,
        ("flash_attention_fwd", 128, 1, QWEN_PATCHES, False):
            n_cross * (QWEN_NEW - 1)}
    runs, graphed_shapes = {}, {}
    for name, kw in (("greedy", {}), ("beam", {"num_beams": 4})):
        r, shapes, _, _ = graphed_and_twin(
            torch, m, lambda kw=kw: m.generate(ids, pix,
                                               max_new_tokens=QWEN_NEW, **kw),
            f"qwen2_vl {name}", want, QWEN_NEW, want_shapes)
        r["k2_by_shape"] = {"/".join(map(str, k[1:])): n
                            for k, n in shapes.items()}
        r.pop("routes")
        runs[name] = r
        graphed_shapes[name] = shapes

    # (c) ROADMAP C2: the generation graph after a dtype round trip
    before = m.generate(ids, pix, max_new_tokens=QWEN_NEW)
    ptrs = [p.data_ptr() for p in m.parameters()]
    m.float()
    m.to(torch.bfloat16)
    moved = ptrs != [p.data_ptr() for p in m.parameters()]
    # the copy is allocated after the round trip: it takes the freed blocks
    fresh = copy.deepcopy(m)
    after = m.generate(ids, pix, max_new_tokens=QWEN_NEW)
    want_c2 = fresh.generate(ids, pix, max_new_tokens=QWEN_NEW)
    c2 = {"storage_moved": moved,
          "equal_to_fresh_copy": bool(torch.equal(after, want_c2)),
          "equal_to_before": bool(torch.equal(after, before)),
          "before_differs_because": "``.to(torch.bfloat16)`` also casts "
                                    "the float32 RoPE buffers",
          "programs": len(m._generate_jit_cache)}
    del fresh, before, after, want_c2
    # the greedy run's own counts: the warm (graphed) call, counters reset
    # just before it, K2 counted by shape at its launch site
    g = graphed_shapes["greedy"]
    kernels["flash_attention_fwd/d64"]["launches"] = g.get(
        ("flash_attention_fwd", 64, QWEN_PATCHES, QWEN_PATCHES, False), 0)
    kernels["flash_attention_fwd/cross"]["launches"] = sum(
        g.get(("flash_attention_fwd", 128, sq, QWEN_PATCHES, False), 0)
        for sq in (QWEN_PROMPT, 1))
    emit({"phase": "qwen2_vl", "card": card, "init_s": init_s,
          "config": dataclasses.asdict(cfg), "batch": QWEN_BATCH,
          "prompt": QWEN_PROMPT, "new_tokens": QWEN_NEW,
          "params": sum(p.numel() for p in m.parameters()),
          **gates, "c2": c2, **runs})
    for tag, g in gates.items():
        check(g["finite"], f"qwen2_vl {tag}: logits are not finite")
        check(g["max_logit_err_kernel_vs_f32"] <= g["tol_kernel_vs_f32"],
              f"qwen2_vl {tag}: kernel path is "
              f"{g['max_logit_err_kernel_vs_f32']} from the float32 model, "
              f"the plain path {g['max_logit_err_plain_vs_f32']} "
              f"(tolerance {g['tol_kernel_vs_f32']})")
    check(moved and c2["equal_to_fresh_copy"],
          f"qwen2_vl C2: after a dtype round trip the tokens differ from a "
          f"fresh copy's ({c2})")
    del m, ids, pix
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the tiny float32 model: card (kernels) against the CPU (plain)
    tcfg = tiny_qwen2_vl_config()
    cpu = _qwen_model(torch, tcfg, "cpu", seed=1)
    card_m = copy.deepcopy(cpu).to(dev)
    t_ids, t_pix = qwen_inputs(torch, tcfg, 3, 7, 17)
    for kw in ({}, {"num_beams": 3, "eos_token_id": 5}):
        on_card = card_m.generate(t_ids, t_pix, max_new_tokens=8, **kw).cpu()
        on_cpu = cpu.generate(t_ids, t_pix, max_new_tokens=8, **kw)
        prog = list(card_m._generate_jit_cache.values())[-1]
        emit({"phase": "qwen2_vl_tiny_f32", "kw": kw,
              "identical": bool(torch.equal(on_card, on_cpu)),
              "graphed": prog.graphed, "traces": prog.traces})
        check(bool(torch.equal(on_card, on_cpu)) and prog.graphed,
              f"qwen2_vl_tiny_f32 {kw}: card tokens {on_card.tolist()} vs "
              f"cpu {on_cpu.tolist()}, graphed {prog.graphed}")


QWEN_TRAIN_STEPS, QWEN_TRAIN_LR = 4, 1e-4


def qwen_batch(torch, cfg, b, s, seed, dev=None):
    """A seeded next-token batch of ``s`` tokens a row with images (the
    reference's ``tests/test_breadth_models.py:214-223`` recipe):
    ids[:, :-1] in, ids[:, 1:] as labels; numpy, or tensors on ``dev``."""
    ids, pix = qwen_inputs(torch, cfg, b, s + 1, seed)
    batch = {"input_ids": ids[:, :-1], "pixel_values": pix,
             "labels": ids[:, 1:]}
    if dev is None:
        return batch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def phase_qwen2_vl_train(torch, kernels, card):
    """Qwen2-VL at its default widths trained by ``build_train_step`` with
    AdamW (lr 1e-4, weight decay 0.01), bf16, 4 images and 64-token
    prompts a step.  Gates: (a) step-1 gradients within 1.2x the plain
    path's error against a float32 copy (:func:`grad_gate`); (b) 4 steps:
    every loss finite, K2 = K5 = K6 = 8 launches a step (the tower's 2 at
    D 64, the decoder's 4 causal and the cross layers' 2 at D 128, by
    shape) and no other attention kernel, K3 11 a step, no plain route,
    the first and last K5 / K6 calls of step 1 the same bits when launched
    again; (c) the tiny float32 model trained 4 steps on the card against
    the CPU (:func:`tiny_card_vs_cpu`)."""
    import numpy as np
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import Qwen2VLConfig, tiny_qwen2_vl_config
    from paddle_tpu_torch.ops import (_dispatch, launch_counts,
                                      reset_launch_counts, shape_counts)
    from paddle_tpu_torch.optimizer import AdamW

    dev = torch.device("cuda")
    cfg = Qwen2VLConfig(dtype="bfloat16")
    m = _qwen_model(torch, cfg, dev)
    m.train()
    n_params = sum(p.numel() for p in m.parameters())
    micro = qwen_batch(torch, cfg, QWEN_BATCH, QWEN_PROMPT, 100, dev)
    grad_gate(torch, m, lambda: copy.deepcopy(m).float(),
              lambda mod: mod.compute_loss(**micro), "qwen2_vl_train_grads",
              {"config": "qwen2_vl", "params": n_params,
               "batch": QWEN_BATCH, "prompt": QWEN_PROMPT})

    opt = AdamW(QWEN_TRAIN_LR, weight_decay=0.01)
    step = build_train_step(m, opt)
    batches = [qwen_batch(torch, cfg, QWEN_BATCH, QWEN_PROMPT, 200 + i, dev)
               for i in range(QWEN_TRAIN_STEPS)]
    calls, losses, step_ms = {}, [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    _dispatch.reset_kernel_paths()
    for i, batch in enumerate(batches):
        with (recording_backward(calls) if i == 0
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    # read before same_bits, whose launches count too
    launches = {k: n for k, n in launch_counts().items() if n}
    shapes = shape_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    same = same_bits(torch, calls)
    del calls
    layers, n_cross = cfg.num_hidden_layers, len(m.cross)
    per_step = cfg.vision_layers + layers + n_cross
    want = {"flash_attention_fwd": per_step,
            "flash_attention_bwd_dq": per_step,
            "flash_attention_bwd_dkv": per_step,
            "rms_norm": 2 * layers + n_cross + 1}
    want = {k: n * QWEN_TRAIN_STEPS for k, n in want.items()}
    want_shapes = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        for key, n in (((64, QWEN_PATCHES, QWEN_PATCHES, False),
                        cfg.vision_layers),
                       ((128, QWEN_PROMPT, QWEN_PROMPT, True), layers),
                       ((128, QWEN_PROMPT, QWEN_PATCHES, False), n_cross)):
            want_shapes[(name, *key)] = n * QWEN_TRAIN_STEPS
    p50 = float(np.median(step_ms[1:]))
    emit({"phase": "qwen2_vl_train", "card": card, "params": n_params,
          "optimizer": f"AdamW({QWEN_TRAIN_LR}, weight_decay=0.01)",
          "batch": QWEN_BATCH, "prompt": QWEN_PROMPT, "losses": losses,
          "step_ms": step_ms, "step_ms_p50_after_first": p50,
          "tokens_per_s": QWEN_BATCH * QWEN_PROMPT / (p50 / 1e3),
          "launches": launches, "routes": routes,
          "k2_k5_k6_by_shape": {"/".join(map(str, k)): n
                                for k, n in shapes.items()},
          "k5_k6_same_bits": same,
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(all(math.isfinite(x) for x in losses),
          f"qwen2_vl_train losses {losses}")
    check(launches == want,
          f"qwen2_vl_train: launches {launches}, expected {want}")
    check(shapes == want_shapes,
          f"qwen2_vl_train: launches by shape {shapes}, expected "
          f"{want_shapes}")
    check(not any(k.endswith("/plain") for k in routes),
          f"qwen2_vl_train: a plain route on the card {routes}")
    check(set(same) == {"flash_attention_bwd_dq_cuda",
                        "flash_attention_bwd_dkv_cuda"} and all(same.values()),
          f"qwen2_vl_train: K5 / K6 not the same bits twice: {same}")
    for name, base in zip(QWEN_BWD, TRAIN_KERNELS):
        kernels[name]["launches"] = shapes.get(
            (base, 64, QWEN_PATCHES, QWEN_PATCHES, False), 0)
    del step, opt, m, batches, micro
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the tiny float32 model: 4 train steps on the card against the CPU
    tcfg = tiny_qwen2_vl_config()
    base = _qwen_model(torch, tcfg, "cpu", seed=2)
    res = tiny_card_vs_cpu(torch, base, [qwen_batch(torch, tcfg, 4, 16,
                                                    300 + i)
                                         for i in range(4)], dev)
    launches = {k: n for k, n in res.pop("launches").items() if n}
    attn = 4 * (tcfg.vision_layers + tcfg.num_hidden_layers
                + tcfg.num_hidden_layers // tcfg.cross_attn_interval)
    want = {k: attn for k in ("flash_attention_fwd",
                              "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv")}
    emit({"phase": "qwen2_vl_train_tiny_f32", **res, "launches": launches})
    check_tiny(res, "qwen2_vl_train_tiny_f32")
    check({k: launches.get(k) for k in want} == want
          and not any(k.endswith("/plain") for k in res["routes"]),
          f"qwen2_vl_train_tiny_f32: launches {launches} (attention "
          f"expected {want}), routes {res['routes']}")


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
    card = phase_card(torch, _build)
    kernels = phase_kernels(torch)
    model, qmodel = phase_model(torch)
    run4 = phase_serving(torch, model, kernels)
    run4b = phase_serving_paged(torch, model, kernels)
    run4c = phase_serving_int8(torch, qmodel, kernels, run4b["metrics"])
    run4d = phase_serving_int8_contiguous(torch, qmodel, kernels,
                                          run4["metrics"])
    vocab = model.config.vocab_size
    chunked = []
    for (phase, label, kw, attention), m, prompts, wave in zip(
            CHUNKED_PHASES, (model, model, qmodel),
            (serving_prompts(vocab), paged_serving_prompts(vocab),
             serving_prompts(vocab)), (run4, run4b, run4d)):
        chunked.append(phase_serving_chunked(
            torch, m, kernels, phase, label, kw, attention, prompts,
            wave["outs"]))
    for (phase, label, kw, attention), m, prompts, base in zip(
            SPEC_PHASES, (model, model, qmodel),
            (serving_prompts(vocab), paged_serving_prompts(vocab),
             paged_serving_prompts(vocab)), (run4, run4b, run4c)):
        phase_serving_spec(torch, m, phase, label, kw, attention, prompts,
                           base)
    phase_serving_spec_chunked_model(torch, model, serving_prompts(vocab),
                                     chunked[0])
    if args.profile:
        phase_profile(torch, model, qmodel)
    phase_generate(torch, model, qmodel, card)
    del model, qmodel
    gc.collect()
    torch.cuda.empty_cache()
    phase_dit(torch, kernels, card, profile=args.profile)
    phase_dit_train(torch, kernels, card, profile=args.profile)
    phase_qwen2_vl(torch, kernels, card)
    phase_qwen2_vl_train(torch, kernels, card)
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
