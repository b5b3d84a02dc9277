#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds every kernel of the serving, sampling and training paths from
the sources in the checkout, holds each against its plain PyTorch version,
runs the model at the full Llama-3-8B width, serves requests through the
engine, generates with ``generate`` (greedy, sampled, beam, int8), samples
and trains DiT-XL/2, generates with and trains Qwen2-VL at its default
widths (in bf16, then as the reference defines it, float32), serves
``LlamaConfig()`` in float32, TinyLlama-1.1B (head_dim 64) and a Llama at
Gemma-2B's widths (head_dim 256) in bf16, trains that Llama at all its
18 layers, and trains a 4-layer cut of the Llama-3-8B model.  Every phase
prints one JSON line; any failed check raises, so the script exits
non-zero.  Phases:

  1. card      — ``nvidia-smi`` name and power limit, torch/CUDA versions,
                 the kernels' build time (one ``nvcc`` per source, all at
                 once) and ptxas's registers / spill bytes per library;
                 fails if ptxas reports that it serialised the
                 ``wgmma.mma_async`` instructions of any kernel (named),
                 or if a build of the Hopper K1 kernel (K1, K1-int8,
                 K1-paged, K1-paged-int8; at head_dim 128, its instance
                 below, at 256 and its instance between) spills or fits
                 no CTA on an SM (``k1_mma``: registers, spills, CTAs an
                 SM);
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
                 (Sq 64, Skv 256, D 128); then every float32 head_dim-128
                 build (the reference's float32 defaults, ``/f32_d128``
                 entries, :func:`phase_f32_d128_rows`): K1, K1-int8,
                 K1-paged, K1-paged-int8 at Llama's decode tick and s = 5,
                 K2 at the prefill wave, ragged GQA, packed and Qwen2-VL's
                 cross shapes, K2-paged(-int8) at a suffix prefill and over
                 the identity view, K5 / K6 at Qwen2-VL's shapes, ragged
                 and packed, each with ptxas's registers and spills (a
                 spill fails); then every bf16 build of K1 and K2-paged
                 below head_dim 128 (``/bf16_d64`` entries,
                 :func:`phase_bf16_head_dim_rows`) at D 16, 64, 72 and
                 96: K1, K1-int8, K1-paged, K1-paged-int8 at TinyLlama's
                 decode tick (B 8, L 2048, 32 / 4 heads; at D 64 also
                 s = 5), K2-paged(-int8) at a 512-query suffix prefill
                 over 64-token blocks, and contract rows (queries that
                 see no key give 0, 8-token scale granules, 16-token
                 blocks, null-tailed tables; at D 72 the int8 builds'
                 8-byte copies); then every bf16 forward build above
                 head_dim 128 (``/bf16_d256`` entries, after a
                 ``bf16_d256_ptxas`` line: a spill fails) at D 136, 192,
                 200 and 256 (136 and 200: the 8-byte int8 copies and
                 K2-paged-int8's CP8 staging): the same K1 and K2-paged
                 rows at a Gemma-2B-wide Llama's 8 / 1 heads (s = 5 at
                 D 256), K2 at the serving wave (B 4 x 2048, causal GQA)
                 and at Sq 77 over Skv 61 (dead rows) at every D, at D
                 256 not causal, packed and Sq 64 over Skv 256, the
                 identity view and its crossover with K1
                 (``crossover_d256``), and K5 / K6 on 256-wide tiles at
                 every D (the training micro-batch's B 4 x 2048 causal,
                 Sq 77 over Skv 61, packed at S 2048, the ring hop, not
                 causal, Sq 64 over Skv 256; dead rows exact, the same
                 bits twice); each also
                 at the tiny model's float32 shapes:
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
                 TTFT, TPOT, ``mixed_step_ms``, ``decode_step_ms`` and
                 ``decode_tick_ms`` (every serving line: the host time of
                 each ``step()`` that ran one decode tick, exact; the
                 engine's ``*_ms`` are its registry histograms' bucket
                 readouts),
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
  4l. serving_mixed — the mixed bf16/int8 pool: phase 4b's engine and
                 pool with ``kv_cache_dtype="mixed"`` on phase 4b's eight
                 requests that share the 1536-token system prompt, beside
                 its eager twin (tokens, launches, routes equal),
                 ``step_traces`` 1, the demote op built once,
                 ``quantized_blocks`` >= 12 and equal to the demotions,
                 ``bytes_by_dtype["int8"]`` = those blocks x the int8
                 block's bytes, the first demoted block equal bit for bit
                 to its round trip on the CPU in float32, K1-paged 32 a
                 tick and K2-paged 32 a wave, no plain route; the count of
                 requests whose tokens equal phase 4b's reported;
  4m. serving_preempt — preemption over a 26-block pool (four requests
                 of 800-1100 tokens, room for three: two priority-0 ones
                 decode, two priority-5 ones arrive), in ``swap`` mode (a
                 20-block pinned host tier) and ``recompute`` mode, each
                 graphed beside its eager twin (tokens, launches, routes,
                 decisions' signature equal), at least one preemption,
                 K1-paged 32 a tick and K2-paged 32 a wave, no block in
                 use after the drain; swap: tokens equal to the
                 ``preempt="off"`` run's and every swapped block read back
                 after its swap-in equal to its swapped-out bytes; then
                 ``cancel`` in five states on chunked engines (the
                 preempted request swapped out or awaiting its re-prefill,
                 one mid chunked prefill, one queued, one decoding: no
                 block in use, the host tier holding only trie blocks),
                 the host tier (an evicted prefix block demoted to the
                 host and promoted by a later hit, tokens equal to the run
                 without a tier), a migration (``export_request`` /
                 ``import_request`` between two engines, tokens equal to
                 the unmigrated run's) and the float32 tiny swap,
                 recompute (wave and chunked) and mixed engines card
                 against CPU (``model_tiny_f32_tiers``: tokens and
                 decisions equal); swap bytes, the host tier's pinned
                 bytes, one block's swap-out / swap-in ms, TTFT and TPOT;
  4n. observability — builds nothing: reads what the observability layer
                 recorded of 4b, 4c and 4m's swap run (each serving run
                 resets the registry, tracer and request log first, so
                 no metric family nears its label cap).  Gates: the
                 registry's ``ops.kernel_path`` holds the kernel routes of
                 K1-paged, K2-paged, RMSNorm (4c: int8, and K4) and no
                 plain route; every 4b request's events in the order
                 admitted < prefill < first_token < retired, its
                 timelines equal to the eager twin's; every swap victim's
                 preempted < swapped_out < swapped_in < resumed <
                 retired, ``kv_cache.swapped_out_blocks`` equal to the
                 engine's count and to the blocks swapped in;
                 ``metrics()`` equal to the registry's series; the cost
                 model on the ``h100`` profile, its bounds partitioning
                 the decode ticks, a swap term > 0 in the swap run; the
                 4b Chrome trace parsed back with one ``serving.decode``
                 span a decode tick.  Reported: measured / predicted tick
                 ratio p50 / p90, drift findings, the phase's seconds;
  4o. serving_router — the control plane: phase 3's model behind
                 ``ReplicaRouter(model, num_replicas=2, policy="prefix")``
                 (paged replicas sharing its weights: 128-token blocks,
                 96 a replica, 8 slots x 4096) replaying
                 ``generate_load``'s seeded trace (16 requests, two
                 tenants with 512-token system prompts, 8-24 new tokens)
                 through ``loadgen.replay``, then an eager twin router.
                 Gates: outputs, placements, the replay's signature,
                 ticks, rejections, launches and routes equal to the
                 twin's; each replica's decode step built once, a graph
                 replay a decode tick and a wave, one prefill build a
                 distinct key; K1-paged 32 a replica's decode tick and
                 K2-paged 32 a wave, no other attention kernel, kernel
                 routes only (in the registry too); prefix-routed tokens
                 and ``route="prefix"`` placements > 0, each on a replica
                 that served the tenant before, pooled prefix hits > 0;
                 the model's tensors not moved; ``/metrics`` of a
                 loopback exposition server equal to the registry's
                 text with ``router.requests``, ``/healthz`` JSON.
                 Reported: goodput, TTFT / TPOT p50 / p90, summed tok/s
                 (graphed and eager), ticks, requests and
                 ``decode_tick_ms`` a replica;
  4p. serving_multihost — the multihost plane: phase 3's model behind
                 three ``EngineWorker`` s (``p0``, ``d0``, ``d1``; paged,
                 128-token blocks, 8 slots x 2048) on loopback transports,
                 replaying ``generate_load``'s seeded trace (8 requests,
                 two tenants with 128-token system prompts, prompts of
                 192-384 tokens, 8-24 new tokens) through
                 ``MultiHostRouter(policy="disagg", prefill=["p0"])``,
                 then an eager twin plane.  Gates: outputs, placements,
                 the timeline signature, ticks and rejections equal to the
                 twin's; every request placed on p0 and finished on d0 or
                 d1; 8 migrations, their bytes the exported blocks' (from
                 the pool's leaf shapes); p0 K2-paged 32 a wave, d0 / d1
                 K1-paged 32 a tick and no wave; each decode step built
                 once, a replay a tick (and a wave), no prefill build on a
                 decode worker; kernel routes only (in the registry too);
                 the model not moved.  A failover leg (eager, policy
                 prefix over d0 and d1) kills d1 while it holds requests:
                 every request finishes with its budget, each victim's
                 timeline ``worker_lost -> failover -> placed`` under its
                 one uid.  Federation: counters equal the workers' own
                 series, a merged Perfetto trace with every worker's track
                 and stitched request tracks, ``/fleet`` and ``/metrics``
                 (``worker=`` labels) over a loopback server, and one
                 streamed ``POST /v1/generate`` whose first chunk comes
                 before its request retires.  Then ``python -m
                 paddle_tpu_torch.serving.multihost --selfcheck`` (two
                 worker processes on the card, one killed) exits 0.
                 Reported: migration seconds (the codec's included),
                 ticks, tok/s, TTFT / TPOT p50 / p90, token agreement of
                 the failover leg, the self-check's and the phase's
                 seconds, the card;
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
  qwen2_vl_f32. — ``Qwen2VLConfig()`` unchanged (float32, head_dim 128
                 in the decoder): greedy and beam-4 ``generate`` graphed
                 beside the eager twin, bit for bit, with exact launches
                 by shape and no plain route; forward and first decode
                 step logits within 1e-4 of the largest logit of the
                 plain path on the card; one train step's loss (rtol
                 1e-5) and gradients (1e-4 of each tensor's largest
                 element) against the plain path, K2 / K5 / K6 by shape;
                 4 AdamW steps: tokens/s, step ms, peak memory;
  serving_f32. — ``LlamaConfig()`` unchanged (float32, 32 layers of 32
                 heads of 128, 26.9 GB of weights): contiguous, paged
                 (prefix cache), int8-KV paged and int8-KV contiguous
                 engines, one after another, on 8 requests of 5..1500
                 prompt tokens, 16 new tokens each; each graphed beside
                 its eager twin (tokens, launches, routes equal),
                 ``step_traces`` 1, the decode kernel 32 a tick and the
                 wave kernel 32 a wave, no plain route; teacher-forced
                 logits of its layout within 1e-4 of the largest plain-
                 path logit (int8 caches: within 1.2x the plain path's
                 distance from a float32 cache); greedy tokens against
                 the plain path reported; tok/s, TTFT, TPOT;
  serving_tinyllama. — TinyLlama-1.1B's published widths (22 layers of
                 32 / 4 heads of 64, hidden 2048, vocab 32000), bf16,
                 seeded weights: serving_f32's four engines (paged at
                 block_len 64) and requests, then the contiguous chunked
                 engine (its chunks on K2-paged over the identity view)
                 and greedy ``generate`` at B 4; each graphed beside its
                 eager twin (tokens, launches, routes equal),
                 ``step_traces`` 1, the decode kernel 22 a tick and the
                 wave (or chunk) kernel 22 a wave (chunk), no plain
                 route, paged: prefix hits; teacher-forced logits of each
                 layout within 1.2x the plain path's distance from a
                 float32 copy on a float32 cache; tok/s, TTFT, TPOT,
                 peak memory;
  serving_d256. — a Llama at Gemma-2B's published widths (18 layers of
                 8 / 1 heads of 256, hidden 2048, intermediate 16384,
                 vocab 256000, tied embeddings; the Llama architecture),
                 bf16, seeded weights, not cut: serving_tinyllama's
                 engines, requests and gates, the decode kernel 18 a
                 tick and the wave (or chunk) kernel 18 a wave (chunk);
                 the decode step beside the weights' byte bound of a
                 tick;
  training_d256. — the same Llama, all 18 layers, trained as phase 5
                 trains (bf16, ``recompute=True``, packed 4 x 2048
                 batches in 2 micro-batches, the same AdamW, 8 steps):
                 step-1 gradients within 1.2x the plain path's error
                 against a float32 copy (summed and per tensor); losses
                 finite and falling; K2 72, K5 = K6 = 36 launches a step,
                 all at head_dim 256; no plain route; step ms, tokens/s,
                 model-FLOPs share (the tied head counted), optimizer
                 state bytes, peak memory;
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
qwen2_vl's greedy run, of K5 and K6 at head_dim 64 from qwen2_vl_train,
of every float32 head_dim-128 build from serving_f32's engines (K2 from
the contiguous engine's waves) and qwen2_vl_f32's train steps (K5, K6),
of every bf16 build of K1 and K2-paged at head_dim 64 from
serving_tinyllama's engines, of every bf16 forward build at head_dim 256
from serving_d256's engines, of K5 and K6 at head_dim 256 from
training_d256; error and times from phase 2) and, last,
``{"ok": true,
"device": {...}}``.

``--profile`` adds a window over 5 graphed ticks of ``serving_f32``'s
contiguous engine (``profile_serving_f32``), the device time of K1,
K1-int8, K1-paged and
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
import collections
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
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 (and float16) tensor cores
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# float32-accurate products on the tensor cores: three TF32 passes (the
# float32 K2 family and K5 / K6, csrc/mma_tf32.cuh) at the 494.7 TFLOP/s
# dense TF32 rate; the least time float32 products could take, so every
# float32 operation bound is taken at it (a row also reports
# bound_ms_cuda_cores, at 67)
F32_TC_FLOPS = 494.7e12 / 3
# float32 q against int8 K / V: an int8 value is exact in TF32, so the
# products take two passes (lo hi + hi hi; the float32 K2-paged-int8 does),
# and every float32-q int8-KV row's operation bound is taken at this rate
F32_I8_TC_FLOPS = 494.7e12 / 2

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
# every float32 head_dim-128 build (the reference's float32 default
# configurations: LlamaConfig(), Qwen2VLConfig()'s decoder) has an entry of
# its own, the kernel of its namesake at (float32, 128): phase 2's
# "/f32_d128" rows, launches from serving_f32 and qwen2_vl_f32
F32_D128 = "/f32_d128"
for _name in ("decode_attention", "decode_attention_int8",
              "decode_attention_paged", "decode_attention_paged_int8",
              "flash_attention_fwd", "flash_attention_fwd_paged",
              "flash_attention_fwd_paged_int8", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
    KERNEL_INFO[_name + F32_D128] = dict(KERNEL_INFO[_name])
# every bf16 build of K1 and K2-paged below head_dim 128 (any Llama whose
# head_dim is not 128: TinyLlama-1.1B at 64) has an entry of its own, the
# kernel of its namesake at bf16: phase 2's "/bf16_d64" rows -- times at
# TinyLlama's head_dim 64, the largest error over D 16, 64, 72 and 96 --
# and launches from serving_tinyllama's engines
BF16_D64 = "/bf16_d64"
BF16_D64_BUILDS = ("decode_attention", "decode_attention_int8",
                   "decode_attention_paged", "decode_attention_paged_int8",
                   "flash_attention_fwd_paged",
                   "flash_attention_fwd_paged_int8")
for _name in BF16_D64_BUILDS:
    KERNEL_INFO[_name + BF16_D64] = dict(KERNEL_INFO[_name])
# every bf16 forward build above head_dim 128 (a Llama at Gemma-2B's
# widths: head_dim 256) has an entry of its own, the kernel of its
# namesake at bf16: phase 2's "/bf16_d256" rows -- times at D 256, the
# largest error over D 136, 192, 200 and 256 -- and launches from
# serving_d256's engines
BF16_D256 = "/bf16_d256"
BF16_D256_BUILDS = BF16_D64_BUILDS + ("flash_attention_fwd",)
for _name in BF16_D256_BUILDS:
    KERNEL_INFO[_name + BF16_D256] = dict(KERNEL_INFO[_name])
# and so does the bf16 backward above head_dim 128 (K5 / K6 on 256-wide
# tiles): phase 2's rows at D 136, 192, 200 and 256 (times at 256),
# launches from training_d256
BF16_D256_BWD = ("flash_attention_bwd_dq" + BF16_D256,
                 "flash_attention_bwd_dkv" + BF16_D256)
for _name in BF16_D256_BWD:
    KERNEL_INFO[_name] = dict(KERNEL_INFO[_name[:-len(BF16_D256)]])
# every float16 forward build (the K1 family, K2 in every layout, K4: the
# bf16 bodies compiled over float16, libraries of their own) has an entry of
# its own, the kernel of its namesake at float16: phase 2's "/f16" rows --
# times at Llama-2-7B's shapes (head_dim 128), the largest error over D 64,
# 72, 128, 136 and 256 -- and launches from serving_f16's engines
F16 = "/f16"
F16_BUILDS = BF16_D256_BUILDS + ("int8_matmul",)
for _name in F16_BUILDS:
    KERNEL_INFO[_name + F16] = dict(KERNEL_INFO[_name])
# and so does the float16 backward (K5 / K6's bf16 bodies over float16,
# each dS row in a power-of-two unit of its own): phase 2's rows at D 64,
# 72, 128, 136 and 256 (times at Llama-2-7B's 128), its range rows, and
# launches from training_f16
F16_BWD = ("flash_attention_bwd_dq" + F16, "flash_attention_bwd_dkv" + F16)
for _name in F16_BWD:
    KERNEL_INFO[_name] = dict(KERNEL_INFO[_name[:-len(F16)]])
# every float32 build at the head dims past its first instances (16, 128;
# K2 and K5 / K6 also 64 and 72): any D <= 256 with D % 8 == 0 -- the K1
# family on 2 and 8 elements a lane, K2 in every layout on the runtime-D
# kernel (and K2-paged's constant-D instances at 64 and 72), K5 / K6 on
# the 3xTF32 kernels -- has an entry of its own, the kernel of its
# namesake at float32: phase 2's "/f32" rows, the largest error over D 64,
# 72, 96, 136, 192, 200 and 256; the K1 family and K2-paged(-int8) timed at
# TinyLlama's D 64 and launched by serving_f32_tinyllama's engines, K2 and
# K5 / K6 timed at D 256 and launched by training_f32_d256
F32 = "/f32"
F32_SERVING_BUILDS = BF16_D64_BUILDS
F32_BWD = ("flash_attention_bwd_dq" + F32, "flash_attention_bwd_dkv" + F32)
for _name in BF16_D256_BUILDS:
    KERNEL_INFO[_name + F32] = dict(KERNEL_INFO[_name])
for _name in F32_BWD:
    KERNEL_INFO[_name] = dict(KERNEL_INFO[_name[:-len(F32)]])
del _name
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
# float16 rounds 8x finer (2^-11): bf16's bound scaled by 8, with margin
# (2e-3, as the float16 forward rows' 2e-3)
BWD_REL_TOL_F16 = 2e-3
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


# the script's start: each phase line carries its seconds since (t_s)
T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line.  A phase line closes a unit of work: the
    observability layer is reset after it, so the next unit starts from
    an empty registry, tracer and request log and no metric family nears
    its label cap (FLAGS_metrics_max_children), however many engines the
    script builds; what a later phase reads of a run was captured when the
    run drained (:func:`obs_capture`)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        from paddle_tpu_torch import observability
        observability.reset()


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# -- timing ---------------------------------------------------------------------

# phase 2's timing loops, sized so the whole script ends within 900 s on a
# slow host (identical trees ran 849.5 and 983.4 s on two hosts with 300 /
# 100 / 100 ms, 5 calls and 40-call windows; with 60 / 40 / 40 ms, 3 calls
# and 20-call windows 735.2 and 962.4 s; with 40 / 25 ms 725.65 s on a
# fast host; with 20 / 12 ms 875.1 s on a host as slow as the 962.4 s
# one): a timed run spends about its budget in calls, at least
# MIN_TIMED_CALLS and at most 200 of them, and gives the device time and
# the host's enqueue time of the same calls
TIME_BUDGET_MS = 20.0           # a kernel or a library call
PLAIN_BUDGET_MS = 12.0          # a plain version (slow: often the minimum)
MIN_TIMED_CALLS = 3
DEVICE_CALLS = 20               # calls in a profiler window


def time_ms(torch, fns, budget_ms: float = TIME_BUDGET_MS) -> float:
    """Mean time of one call, by CUDA events around a run of calls: the
    device time, or the host's enqueue time where the host is slower.
    ``fns`` is a list of closures over different input copies, cycled so a
    call finds its inputs outside the 50 MB L2 cache, as the serving path
    does."""
    return _time(torch, fns, budget_ms)[0]


def _time(torch, fns, budget_ms):
    fns[0]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    est = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(200, max(MIN_TIMED_CALLS, budget_ms / est)))
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


def device_ms(torch, fns, n: int = DEVICE_CALLS) -> float:
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


class BoundMs(float):
    """A bound in ms; float32 work's also carries its bound at the CUDA
    cores' rate, ``cuda_cores_ms``."""
    cuda_cores_ms = None


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    ms = BoundMs(max(t_bytes, t_ops))
    if peak_ops in (F32_TC_FLOPS, F32_I8_TC_FLOPS):
        ms.cuda_cores_ms = max(t_bytes, ops / F32_FLOPS * 1e3)
    return ms, "bytes" if t_bytes >= t_ops else "operations"


def _common(a, b):
    """a and b in float64 where either is (the float32 rows' truth, the
    plain version computed in float64), else in float32."""
    import torch
    dt = (torch.float64 if torch.float64 in (a.dtype, b.dtype)
          else torch.float32)
    return a.to(dt), b.to(dt)


def max_err(a, b) -> float:
    a, b = _common(a, b)
    return float((a - b).abs().max().item())


def within(a, b, atol: float, rtol: float) -> bool:
    a, b = _common(a, b)
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all().item())


def as_f64(ts):
    """A tuple of tensors with its floating ones in float64 (int8 payloads
    stay as they are): the inputs of the float32 rows' truth."""
    return tuple(t.double() if t.is_floating_point() else t for t in ts)


def lse_err(lse, want) -> float:
    """Largest |lse - want| over the rows that see a key (a dead row's
    -1e30 is held exactly by :func:`dead_rows_ok`; in float64 the float32
    -1e30 differs from it by 1.5e22)."""
    live = want > -1e29
    return max_err(lse[live], want[live]) if bool(live.any().item()) else 0.0


def vs_f64(got, want, truth, tol, lse=None):
    """A float32 forward row's yardstick: ``truth``, the plain version in
    float64, in place of ``want``, the float32 one.  Returns the truth,
    ``tol`` named as taken of it, and the row's two distances: the
    kernel's from the float32 plain version and that version's from the
    truth.  ``lse``: (kernel, float32 plain, float64 plain) lse, whose
    distances over the rows that see a key count too."""
    near, far = max_err(got, want), max_err(want, truth)
    if lse is not None:
        near = max(near, lse_err(lse[0], lse[1]))
        far = max(far, lse_err(lse[1], lse[2]))
    return truth, tol + " of the float64 plain version", {
        "max_err_vs_f32_plain": near, "f32_plain_max_err_vs_f64": far}


# -- phase 1 ------------------------------------------------------------------------

def ptxas_functions(log: str):
    """Registers and spill-store bytes of each entry function in ptxas's
    ``-v`` report (mangled names; the Hopper K2 kernel's template
    arguments are <SEG, PAGED, INT8, CP8, HD>, so ``ILb0ELb1ELb1ELb0ELi256EE``
    is K2-paged-int8 on 256-wide tiles)."""
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
# its instances of each build: (suffix, PAD, ring row PD, a head_dim it runs)
K1_MMA_INSTANCES = (("", 0, 128, 128), ("/padded", 1, 128, 64),
                    ("/wide", 0, 256, 256), ("/wide_padded", 1, 256, 200))


def mma_decode_builds(ptxas):
    """Each build of the Hopper K1 kernel (``decode_mma_kernel<INT8, PAGED,
    PAD, PD>``), at head_dim 128, (``/padded``, PAD) below, at 256
    (``/wide``: 256-wide ring rows) and (``/wide_padded``) between: ptxas's
    registers and spill bytes (when this process built the library) and
    the CTAs that fit on one SM (minus a CUDA error)."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    lib = da._lib()
    fns = ptxas.get("decode_attention", {}).get("functions", {})
    out = {}
    for name, int8, paged in K1_MMA_BUILDS:
        for suffix, pad, pd, d in K1_MMA_INSTANCES:
            tag = f"decode_mma_kernelILb{int8}ELb{paged}ELb{pad}ELi{pd}E"
            row = next((dict(r) for f, r in fns.items() if tag in f), {})
            row["ctas_per_sm"] = lib.decode_attention_mma_ctas_per_sm(
                int8, paged, d)
            out[name + suffix] = row
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
    esz = 4 if dt == torch.float32 else 2
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
    against ``flash_attention_bwd_reference`` on the same out / lse
    (float32 rows: that plain version in float64, the float32 one's
    distance reported beside), and
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
    esz = 4 if dt == torch.float32 else 2
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
    exact = None
    if dt == torch.float32:
        # the float32 rows' yardstick: the plain version on the same inputs
        # in float64.  At B 4 x 2048 the float32 plain version's dk / dv
        # (sums of G x Sq terms) are themselves 1.0-3.0e-5 from it, up to
        # 1.6x the bar (chip_f32_bwd_accuracy.py; NVIDIA H100 80GB HBM3,
        # 700 W), so it is reported beside, not held to (1e-5, 1e-5)
        exact = flash_attention_bwd_reference(
            *(t.double() for t in (q, k, v, out, lse, do, dlse)), **kw)
    torch.cuda.synchronize()
    with reference_mode():
        plain_ms = time_ms(torch, [
            lambda t=t: flash_attention_bwd_reference(
                t[0], t[1], t[2], t[5], t[6], t[3], t[4], **kw)
            for t in sets], budget_ms=PLAIN_BUDGET_MS)
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
        vs64 = {}
        if exact is not None:
            truth = (exact[0],) if name == names[0] else exact[1:]
            vs64 = {"max_err_vs_f32_plain": max(
                         max_err(g, w) for g, w in zip(got, want)),
                     "f32_plain_max_err_vs_f64": max(
                         max_err(w, t) for w, t in zip(want, truth))}
            want = truth
        err = max(max_err(g, w) for g, w in zip(got, want))
        rels = [rel_l2(g, w) for g, w in zip(got, want)]
        if dt != torch.float32:
            rel_tol = (BWD_REL_TOL_BF16 if dt == torch.bfloat16
                       else BWD_REL_TOL_F16)
            tol = f"relative L2 per tensor <= {rel_tol}"
            ok = max(rels) <= rel_tol
        else:
            atol, rtol = tols(dt)
            tol = f"atol {atol} + rtol {rtol} of the float64 plain version"
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
                        F32_TC_FLOPS if dt == torch.float32 else BF16_FLOPS)
        record(name, tag, err, tol + ", finite, dead rows (keys) 0, "
               "the same bits twice", ok,
               kfns, plain_ms, lib_ms, bms, by, main,
               note=BWD_LIBRARY_NOTE + (
                   "; " + SEGMENTED_LIBRARY_NOTE if lib_mask is not None
                   else ""),
               extra=dict(bwd_extra, rel_l2=rels, head_dim=d,
                          deterministic=same[name], **vs64,
                          plain_note="flash_attention_bwd_reference: dq, "
                                     "dk and dv together"))
    del exact
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
    from paddle_tpu_torch.ops.cuda import _build
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    results = {}

    def tols(dt):
        # bf16 output: 2^-8 relative, f32 inside; float16: 2^-11, bf16's
        # scaled by 8x finer rounding with margin; float32: sum order only
        return {bf16: (1e-2, 1e-2), f16: (2e-3, 2e-3)}.get(dt, (1e-5, 1e-5))

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # ptxas's registers and spills of every float32 head_dim-128 build,
    # beside each of its rows (a spill fails)
    f32_regs = f32_d128_ptxas(_build.build_log)
    emit({"phase": "f32_d128_ptxas", "functions": f32_regs})
    check(all(r is None or r["spill_stores"] == 0
              for fns in f32_regs.values() for r in fns.values()),
          f"a float32 head_dim-128 build spills: {f32_regs}")
    # and of every bf16 instance above head_dim 128
    wide_regs = ptxas_of(_build.build_log, BF16_D256_FUNCTIONS)
    emit({"phase": "bf16_d256_ptxas", "functions": wide_regs})
    check(all(r is None or r["spill_stores"] == 0
              for fns in wide_regs.values() for r in fns.values()),
          f"a bf16 build above head_dim 128 spills: {wide_regs}")
    # and of every float32 instance past the first ones (a spill fails)
    f32_new_regs = ptxas_of(_build.build_log, F32_FUNCTIONS)
    emit({"phase": "f32_ptxas", "functions": f32_new_regs})
    check(all(r is None or r["spill_stores"] == 0
              for fns in f32_new_regs.values() for r in fns.values()),
          f"a float32 build past its first instances spills: "
          f"{f32_new_regs}")
    # and of every float16 instance, beside its bf16 twin's registers
    f16_regs = f16_ptxas(_build.build_log)
    emit({"phase": "f16_ptxas", "functions": f16_regs})
    check(all(fns is None or (fns and all(
        r["spill_stores"] == 0 for r in fns.values()))
        for fns in f16_regs.values()),
        f"a float16 build spills or has no instance: {f16_regs}")

    def record(name, shape, err, tol, ok, kfns, plain_ms, lib_ms, bms, by,
               main, note=None, extra=None):
        # the device time and the host's enqueue time (Python + launch)
        # of one loop of calls
        ms, hms = _time(torch, kfns, TIME_BUDGET_MS)
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
        cores = getattr(bms, "cuda_cores_ms", None)
        if cores is not None:
            row["bound_ms_cuda_cores"] = cores
        if note:
            row["library_note"] = note
        if name.endswith(F32_D128):
            row["ptxas"] = f32_regs[name[:-len(F32_D128)]]
        if name.endswith(BF16_D256):
            row["ptxas"] = wide_regs[name[:-len(BF16_D256)]]
        if name.endswith(F16):
            row["ptxas"] = f16_regs[name[:-len(F16)]]
        if name.endswith(F32):
            row["ptxas"] = f32_new_regs[name[:-len(F32)]]
        row.update(extra or {})
        emit(row)
        check(ok, f"{name} {shape}: max error {err} beyond {tol}")
        agg = results.setdefault(name, {"max_abs_err": 0.0})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        if main:
            agg.update(shape=shape, ms=ms, timed_by=timed_by,
                       plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms)
            if cores is not None:
                agg["bound_ms_cuda_cores"] = cores
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
        bms, by = bound(nbytes, ops,
                        BF16_FLOPS if dt == bf16 else F32_TC_FLOPS)
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
                budget_ms=PLAIN_BUDGET_MS)
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
        bms, by = bound(nbytes, ops,
                        BF16_FLOPS if dt == bf16 else F32_TC_FLOPS)
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
            atol, rtol = tols(dt)
            lse_tol = 1e-3 if dt == bf16 else 1e-5
            tol, fwd_extra = f"out atol {atol} + rtol {rtol}, lse {lse_tol}", {}
            with reference_mode():
                ref, ref_lse = flash_attention(q, k, v, return_lse=True, **kw)
                if dt == f32:   # the float32 rows' truth: float64
                    ex, ex_lse = flash_attention(
                        q.double(), k.double(), v.double(), return_lse=True,
                        **kw)
                    ref, tol, fwd_extra = vs_f64(out, ref, ex, tol,
                                                 (lse, ref_lse, ex_lse))
                    ref_lse = ex_lse
                    del ex, ex_lse
            torch.cuda.synchronize()
            err, lerr = max_err(out, ref), lse_err(lse, ref_lse)
            ok = (within(out, ref, atol, rtol) and lerr <= lse_tol
                  and dead_rows_ok(torch, keep, b, out, lse))
            kfns = [lambda t=t: flash_attention_fwd_cuda(t[0], t[1], t[2],
                                                         **kw) for t in sets]
            with reference_mode():
                plain_ms = time_ms(torch, [
                    lambda t=t: flash_attention(t[0], t[1], t[2], **kw)
                    for t in sets], budget_ms=PLAIN_BUDGET_MS)
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
                            BF16_FLOPS if dt == bf16 else F32_TC_FLOPS)
            record("flash_attention_fwd", tag, max(err, lerr),
                   tol + ", dead rows out 0 and lse -1e30", ok, kfns, plain_ms,
                   lib_ms, bms, by, False, note=SEGMENTED_LIBRARY_NOTE,
                   extra=dict(seg_extra, **fwd_extra))
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
                for t in sets], budget_ms=PLAIN_BUDGET_MS)
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
        bms, by = bound(nbytes, ops,
                        BF16_FLOPS if dt == bf16 else F32_TC_FLOPS)
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
            plain_ms = time_ms(torch, kfns, budget_ms=PLAIN_BUDGET_MS)
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
        bms, by = bound(nbytes, ops,
                        BF16_FLOPS if dt == bf16 else F32_I8_TC_FLOPS)
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
            plain_ms = time_ms(torch, kfns, budget_ms=PLAIN_BUDGET_MS)
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
        bms, by = bound(nbytes, ops,
                        BF16_FLOPS if dt == bf16 else F32_I8_TC_FLOPS)
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
    phase_f32_d128_rows(torch, record, randn, int8_payload, int8_scales,
                        tols)
    phase_bf16_head_dim_rows(torch, record, randn, int8_payload,
                             int8_scales, tols)
    phase_bf16_head_dim_rows(torch, record, randn, int8_payload,
                             int8_scales, tols, wide=True)
    phase_f16_rows(torch, record, randn, int8_payload, int8_scales, tols)
    phase_f32_rows(torch, record, randn, int8_payload, int8_scales, tols)

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
            # float16 x (the /f16 entry): Llama-2-7B's decode tick at every
            # projection shape, a short wave and the 256-row limit
            (f16, 8, 4096, 11008, True),           # gate_proj, up_proj
            (f16, 8, 4096, 4096, False),           # q, k, v, o_proj
            (f16, 8, 11008, 4096, False),          # down_proj
            (f16, 8, 4096, 32000, False),          # lm_head
            (f16, 64, 4096, 11008, False),
            (f16, 256, 4096, 4096, False),
            (f32, 8, 64, 32, False),
            (f32, 8, 128, 64, False),
            (f32, 3, 64, 256, False)):
        atol, rtol = tols(dt)
        esz = 4 if dt == f32 else 2
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
            for t in sets], budget_ms=PLAIN_BUDGET_MS)
        lib_ms = time_ms(torch, [lambda t=t: torch.matmul(t[0], t[3])
                                 for t in sets])
        nbytes = k * n + 4 * n + (rows * k + rows * n) * esz
        bms, by = bound(nbytes, 2 * rows * k * n,
                        F32_I8_TC_FLOPS if dt == f32 else BF16_FLOPS)
        record("int8_matmul" + (F16 if dt == f16 else ""),
               f"rows={rows} K={k} N={n} int8 w, "
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
        # RMSNorm's operations are no products: the CUDA cores' rate (the row
        # is bound by its bytes at either)
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


def k2_rows(torch, record, randn, tols, rows):
    """Phase 2's rows of K2 over contiguous K/V, one a spec (name, dtype,
    B, Sq, Skv, Hq, Hkv, D, causal, segments, main) -- segments None,
    "packed" (packed documents) or "ring" (separate kv ids, queries whose
    id matches no key): out, lse and the dead rows (no visible key: out 0,
    lse -1e30) held against the plain version (float32 rows: that plain
    version in float64, the float32 one's distance reported beside), the
    same bits on a second call, beside SDPA (enable_gqa; with a dense mask
    where one is needed)."""
    from paddle_tpu_torch.ops import (flash_attention,
                                      flash_attention_fwd_cuda)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    for (name, dt, b, sq, skv, hq, hkv, d, causal, segments, main) in rows:
        atol, rtol = tols(dt)
        lse_tol = 1e-3 if dt == bf16 else 1e-5
        half = dt in (bf16, torch.float16)
        esz = 2 if half else 4
        seg = kv_seg = None
        ring = segments == "ring"
        if ring:
            ids_kv = packed_segments(b, skv, seed=skv)
            ids_q = (packed_segments(b, sq, seed=sq, lo=3, hi=6)
                     + ids_kv.max(1, keepdims=True) - 1)
            seg = torch.from_numpy(ids_q).to(dev)
            kv_seg = torch.from_numpy(ids_kv).to(dev)
        elif segments == "packed":
            seg = torch.from_numpy(packed_segments(b, sq, seed=sq)).to(dev)
        kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
        keep = visible_pairs(torch, sq, skv, causal, seg,
                             seg if kv_seg is None else kv_seg, dev)
        pairs = int(keep.expand(b, sq, skv).sum().item())
        n_dead = int((~keep.any(-1)).expand(b, sq).sum().item())
        nb = b * (2 * sq * hq + 2 * skv * hkv) * d * esz
        sets = [(randn(b, sq, hq, d, dtype=dt), randn(b, skv, hkv, d, dtype=dt),
                 randn(b, skv, hkv, d, dtype=dt)) for _ in range(copies(nb))]
        q, k, v = sets[0]
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        with reference_mode():
            ref, ref_lse = flash_attention(q, k, v, return_lse=True, **kw)
        tol, vs64 = f"out atol {atol} + rtol {rtol}, lse {lse_tol}", {}
        if dt == torch.float32:
            # the float32 rows' yardstick: the plain version on the same
            # inputs in float64, the float32 one's distance beside
            with reference_mode():
                exact, exact_lse = flash_attention(
                    q.double(), k.double(), v.double(), return_lse=True,
                    **kw)
            ref, tol, vs64 = vs_f64(out, ref, exact, tol,
                                    (lse, ref_lse, exact_lse))
            ref_lse = exact_lse
        torch.cuda.synchronize()
        err, lerr = max_err(out, ref), lse_err(lse, ref_lse)
        # the same bits twice (no atomics, no split over keys)
        again = flash_attention_fwd_cuda(q, k, v, **kw)
        same = bool(torch.equal(out, again[0])
                    and torch.equal(lse, again[1]))
        del again
        ok = (within(out, ref, atol, rtol) and lerr <= lse_tol
              and dead_rows_ok(torch, keep, b, out, lse) and same
              and bool(torch.isfinite(out).all().item())
              and (n_dead > 0) == (ring or (causal and sq > skv)))
        kfns = [lambda t=t: flash_attention_fwd_cuda(*t, **kw) for t in sets]
        with reference_mode():
            plain_ms = time_ms(torch, [
                lambda t=t: flash_attention(*t, **kw) for t in sets],
                budget_ms=PLAIN_BUDGET_MS)
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
                        BF16_FLOPS if half else F32_TC_FLOPS)
        tag = (f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} "
               f"{'causal' if causal else 'causal=False'} "
               f"{'ring-hop kv_segment_ids ' if ring else ''}"
               f"{'packed ' if segments == 'packed' else ''}{str(dt)[6:]}")
        record(name, tag, max(err, lerr),
               tol + ", dead rows out 0 and lse -1e30", ok, kfns, plain_ms,
               lib_ms, bms, by, main,
               note=SEGMENTED_LIBRARY_NOTE if mask is not None else None,
               extra={"head_dim": d, "visible_pairs": pairs,
                      "dead_rows": n_dead, "deterministic": same, **vs64,
                      "library_kernel": top_kernel(torch, lfns[0])})
        del sets, q, k, v, out, lse, ref, ref_lse


def k5_k6_rows(torch, record, randn, tols, rows):
    """Phase 2's rows of K5 / K6 (:func:`backward_rows`), one a spec
    (names, dtype, B, Sq, Skv, Hq, Hkv, D, causal, segments, main) --
    segments None, "packed" (packed documents) or "ring" (separate kv ids,
    queries whose id matches no key); a row must have dead rows exactly
    when it is the ring-hop form or causal with Sq > Skv."""
    dev = torch.device("cuda")
    for (names, dt, b, sq, skv, hq, hkv, d, causal, segments, main) in rows:
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


def phase_head_dim_rows(torch, record, randn, tols):
    """Phase 2's rows of K2 at the head dims below 128 (the contiguous
    build takes any D <= 128 with D % 8 == 0 on zero-padded 128-wide
    tiles; float32 the 3xTF32 body at 64 and 72): bf16 D 72 at
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
    Sq 77 / Skv 61) and 64.  The float32 head_dim-128 builds (the
    reference's defaults, ``/f32_d128`` entries) take both loops' last
    rows: K2 at LlamaConfig()'s prefill wave (B 4, S 2048, 32 heads,
    causal), ragged causal GQA (dead rows), packed documents at S 300 and
    Qwen2-VL's cross shapes; K5 / K6 at Qwen2-VL's decoder and cross
    shapes, ragged causal GQA, packed documents and the training
    micro-batch's shapes (B 2 x 2048 packed, B 4 x 2048 causal, 32 / 4
    heads)."""
    bf16, f32 = torch.bfloat16, torch.float32
    f32_k2 = "flash_attention_fwd" + F32_D128
    k2_rows(torch, record, randn, tols, (
        ("flash_attention_fwd/d72", bf16, DIT_BATCH, DIT_TOKENS,
         DIT_TOKENS, DIT_HEADS, DIT_HEADS, DIT_HEAD_DIM, False, None,
         True),
        ("flash_attention_fwd/d72", bf16, 2, 77, 61, 8, 2, 72, True,
         None, False),
        ("flash_attention_fwd/d72", bf16, 2, 256, 512, 8, 2, 72, True,
         "ring", False),
        ("flash_attention_fwd", bf16, 4, 512, 512, 8, 8, 64, False,
         None, False),
        ("flash_attention_fwd", bf16, 2, 77, 61, 8, 2, 64, True, None,
         False),
        ("flash_attention_fwd/d72", f32, 4, 16, 16, 2, 2, 72, False,
         None, False),
        ("flash_attention_fwd/d72", f32, 2, 77, 61, 4, 2, 72, True,
         None, False),
        ("flash_attention_fwd", f32, 2, 70, 70, 4, 2, 64, False, None,
         False),
        ("flash_attention_fwd/d64", bf16, QWEN_BATCH, QWEN_PATCHES,
         QWEN_PATCHES, QWEN_VISION_HEADS, QWEN_VISION_HEADS, 64, False,
         None, True),
        ("flash_attention_fwd/cross", bf16, QWEN_BATCH, 1, QWEN_PATCHES,
         QWEN_HEADS, QWEN_HEADS, 128, False, None, True),
        ("flash_attention_fwd/cross", bf16, QWEN_BATCH, QWEN_PROMPT,
         QWEN_PATCHES, QWEN_HEADS, QWEN_HEADS, 128, False, None,
         False),
        # float32 at head_dim 128 (the reference's defaults): the
        # prefill wave of LlamaConfig(), ragged causal GQA, packed
        # documents at an unaligned S, Qwen2-VL's cross shapes
        (f32_k2, f32, 4, F32_L, F32_L, F32_HEADS, F32_HEADS, 128, True,
         None, True),
        (f32_k2, f32, 2, 77, 61, 8, 2, 128, True, None, False),
        (f32_k2, f32, 2, 300, 300, 8, 2, 128, True, "packed", False),
        (f32_k2, f32, QWEN_BATCH, QWEN_PROMPT, QWEN_PATCHES, QWEN_HEADS,
         QWEN_HEADS, 128, False, None, False),
        (f32_k2, f32, QWEN_BATCH, 1, QWEN_PATCHES, QWEN_HEADS,
         QWEN_HEADS, 128, False, None, False)))

    f32_bwd = tuple(n + F32_D128 for n in TRAIN_KERNELS)
    k5_k6_rows(torch, record, randn, tols, (
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
             QWEN_HEADS, QWEN_HEADS, 128, False, None, False),
            # float32 at head_dim 128: Qwen2VLConfig()'s decoder and cross
            # shapes, ragged causal GQA, packed documents
            (f32_bwd, f32, QWEN_BATCH, QWEN_PROMPT, QWEN_PROMPT, QWEN_HEADS,
             QWEN_HEADS, 128, True, None, True),
            (f32_bwd, f32, QWEN_BATCH, QWEN_PROMPT, QWEN_PATCHES,
             QWEN_HEADS, QWEN_HEADS, 128, False, None, False),
            (f32_bwd, f32, 2, 77, 61, 8, 2, 128, True, None, False),
            (f32_bwd, f32, 2, 300, 300, 8, 2, 128, True, "packed", False),
            # and the training micro-batch's shapes at TinyLlama's heads
            # (ROADMAP C6: dk / dv over G x Sq terms, 1e-5 of float64)
            (f32_bwd, f32, 2, F32_L, F32_L, TL_HEADS, TL_KV_HEADS, 128, True,
             "packed", False),
            (f32_bwd, f32, 4, F32_L, F32_L, TL_HEADS, TL_KV_HEADS, 128, True,
             None, False)))


# the reference's float32 defaults at head_dim 128: LlamaConfig() (32 / 32
# heads, hidden 4096) and Qwen2VLConfig()'s decoder (8 / 8 heads)
F32_HEADS = 32
F32_L = 2048                    # serving_f32's max_length
F32_TICK_POS = [0, 2047, 17, 1000, 1500, 300, 511, 128]
# the C functions of each float32 head_dim-128 build (ptxas's mangled
# names contain these): K1 decode_attention_kernel<float, KV, 4, 8, PAGED>,
# K2 the 3xTF32 body flash_fwd_tf32_kernel<8, 8, 16, SEG, PAGED, INT8> (row
# groups, n-tiles of 8 keys a key tile, column tiles a warp), K5 / K6 the
# 3xTF32 kernels bwd_dq_tf32_kernel<128, 2, 16> and
# bwd_dkv_tf32_kernel<64, 3, 16> (rows a CTA, stages, column tiles a warp)
F32_K2_BUILDS = {"flash_attention_fwd": ("ELb0ELb0ELb0EE", "ELb1ELb0ELb0EE"),
                 "flash_attention_fwd_paged": ("ELb0ELb1ELb0EE",),
                 "flash_attention_fwd_paged_int8": ("ELb0ELb1ELb1EE",)}
F32_D128_FUNCTIONS = {
    "decode_attention": ("decode_attention_kernelIffLi4ELi8ELb0EE",),
    "decode_attention_int8": ("decode_attention_kernelIfaLi4ELi8ELb0EE",),
    "decode_attention_paged": ("decode_attention_kernelIffLi4ELi8ELb1EE",),
    "decode_attention_paged_int8": (
        "decode_attention_kernelIfaLi4ELi8ELb1EE",),
    **{build: tuple(f"flash_fwd_tf32_kernelILi8ELi8ELi16{b}" for b in bits)
       for build, bits in F32_K2_BUILDS.items()},
    "flash_attention_bwd_dq": ("bwd_dq_tf32_kernelILi128ELi2ELi16EE",),
    "flash_attention_bwd_dkv": ("bwd_dkv_tf32_kernelILi64ELi3ELi16EE",),
}


# the C functions of each bf16 build above head_dim 128: the K1 family's
# decode_mma_kernel<INT8, PAGED, PAD, 256> (D 256, and PAD: 136-248), K2's
# flash_attention_fwd_wgmma_kernel<SEG, PAGED, INT8, CP8, 256>, K5 / K6's
# 256-wide kernels
BF16_D256_FUNCTIONS = {
    name: tuple(f"decode_mma_kernelILb{int8}ELb{paged}ELb{pad}ELi256EE"
                for pad in (0, 1))
    for name, int8, paged in K1_MMA_BUILDS}
BF16_D256_FUNCTIONS.update({
    "flash_attention_fwd": tuple(
        f"flash_attention_fwd_wgmma_kernelILb{seg}ELb0ELb0ELb0ELi256EE"
        for seg in (0, 1)),
    "flash_attention_fwd_paged": (
        "flash_attention_fwd_wgmma_kernelILb0ELb1ELb0ELb0ELi256EE",),
    "flash_attention_fwd_paged_int8": tuple(
        f"flash_attention_fwd_wgmma_kernelILb0ELb1ELb1ELb{cp8}ELi256EE"
        for cp8 in (0, 1)),
    # K5 / K6's bwd_dq_wgmma_wide_kernel<SEG>, bwd_dkv_wgmma_wide_kernel<SEG>
    "flash_attention_bwd_dq": tuple(f"bwd_dq_wgmma_wide_kernelILb{seg}EE"
                                    for seg in (0, 1)),
    "flash_attention_bwd_dkv": tuple(f"bwd_dkv_wgmma_wide_kernelILb{seg}EE"
                                     for seg in (0, 1))})


def ptxas_of(build_log, functions):
    """{build: {function tag: registers / spill bytes}} of ``functions``
    ({build: tags}), from this process's ptxas reports of the default
    libraries (None for a library an earlier process built; the float16
    libraries, whose functions can carry the same names, are
    :func:`f16_ptxas`'s)."""
    from paddle_tpu_torch.ops.cuda import _build
    fns = {}
    for lib, log in build_log.items():
        if lib not in _build.VARIANTS:
            fns.update(ptxas_functions(log))
    return {build: {tag: next((r for f, r in fns.items() if tag in f),
                              None) for tag in tags}
            for build, tags in functions.items()}


# the C functions of each float16 build (every instance whose mangled name
# holds a tag): the K1 family's decode_mma_kernel<INT8, PAGED, ...>, K2's
# flash_attention_fwd_wgmma_kernel<SEG, PAGED, INT8, ...>, K4's wgmma
# kernel and its split-K reduction, K5 / K6's Hopper kernels
F16_FUNCTIONS = {
    name: (f"decode_mma_kernelILb{int8}ELb{paged}E",)
    for name, int8, paged in K1_MMA_BUILDS}
F16_FUNCTIONS.update({
    "flash_attention_fwd": tuple(
        f"flash_attention_fwd_wgmma_kernelILb{seg}ELb0ELb0E"
        for seg in (0, 1)),
    "flash_attention_fwd_paged": (
        "flash_attention_fwd_wgmma_kernelILb0ELb1ELb0E",),
    "flash_attention_fwd_paged_int8": (
        "flash_attention_fwd_wgmma_kernelILb0ELb1ELb1E",),
    "int8_matmul": ("int8_matmul_wgmma_kernel", "int8_matmul_reduce"),
    # K5 / K6: bwd_dq_wgmma(_wide)_kernel<SEG>, bwd_dkv_wgmma(_wide)_kernel
    "flash_attention_bwd_dq": tuple(
        f"bwd_dq_wgmma{w}_kernelILb{seg}EE" for w in ("", "_wide")
        for seg in (0, 1)),
    "flash_attention_bwd_dkv": tuple(
        f"bwd_dkv_wgmma{w}_kernelILb{seg}EE" for w in ("", "_wide")
        for seg in (0, 1))})
# the element types as mangled names spell them
F16_TYPE, BF16_TYPE = "6__half", "13__nv_bfloat16"
# a mangled name's anonymous-namespace prefix (it carries a build hash)
ANON_PREFIX = re.compile(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+")


def f16_ptxas(build_log):
    """{build: {function: registers and spill bytes, beside the bf16
    twin's registers}} of every float16 build (``F16_FUNCTIONS``), from
    this process's ptxas reports of the float16 libraries
    (``_build.VARIANTS``) and of the default library of their source (the
    same function at bf16); None for a library an earlier process
    built."""
    from paddle_tpu_torch.ops.cuda import _build
    out = {}
    for build, tags in F16_FUNCTIONS.items():
        src = ("int8_matmul" if build == "int8_matmul" else
               "decode_attention" if build.startswith("decode")
               else "flash_attention_bwd" if "_bwd_" in build
               else "flash_attention_fwd")
        log = build_log.get(src + "_f16")
        if log is None:
            out[build] = None
            continue
        twins = ptxas_functions(build_log.get(src, ""))
        # a twin's mangled name spells the element type bf16 where the
        # float16 instance's spells __half
        out[build] = {
            ANON_PREFIX.sub("", f): dict(r, bf16_registers=twins.get(
                f.replace(F16_TYPE, BF16_TYPE), {}).get("registers"))
            for f, r in ptxas_functions(log).items()
            if any(t in f for t in tags)}
    return out


# the C functions of each float32 build past its first instances: the K1
# family's decode_attention_kernel<float, KV, EPL, KPI, PAGED> at EPL 2 and
# 8, K2's other 3xTF32 instances flash_fwd_tf32_kernel<RG, NT, CS, SEG,
# PAGED, INT8> (D <= 16, 64, 96; above 128 64-query tiles of 32 keys, two
# warps a row group: D <= 192, 256), K5 / K6's other 3xTF32 instances <BR,
# ST, CS> (rows a CTA, stages, column tiles a warp)
F32_K2_SHAPES = ((8, 8, 2), (8, 8, 8), (8, 8, 12), (4, 4, 12), (4, 4, 16))
F32_FUNCTIONS = {
    name: tuple(f"decode_attention_kernelIf{kv}Li{epl}ELi{kpi}ELb{paged}EE"
                for epl, kpi in ((2, 8), (8, 2 if int8 else 4)))
    for name, int8, paged in K1_MMA_BUILDS
    for kv in ("a" if int8 else "f",)}
F32_FUNCTIONS.update({
    **{build: tuple(f"flash_fwd_tf32_kernelILi{rg}ELi{nt}ELi{cs}{b}"
                    for rg, nt, cs in F32_K2_SHAPES for b in bits)
       for build, bits in F32_K2_BUILDS.items()},
    "flash_attention_bwd_dq": tuple(
        f"bwd_dq_tf32_kernelILi{br}ELi{st}ELi{cs}EE"
        for br, st, cs in ((128, 3, 8), (128, 3, 12), (32, 2, 6),
                           (32, 2, 8))),
    "flash_attention_bwd_dkv": tuple(
        f"bwd_dkv_tf32_kernelILi{br}ELi{st}ELi{cs}EE"
        for br, st, cs in ((64, 3, 8), (64, 3, 12), (32, 2, 12),
                           (32, 2, 16)))})


def f32_d128_ptxas(build_log):
    """:func:`ptxas_of` the float32 head_dim-128 builds."""
    return ptxas_of(build_log, F32_D128_FUNCTIONS)


def phase_f32_d128_rows(torch, record, randn, int8_payload, int8_scales,
                        tols):
    """Phase 2's rows of the float32 head_dim-128 builds of K1 and
    K2-paged (the reference's default configurations; K2's and K5 / K6's
    are :func:`phase_head_dim_rows`'), each held against its plain
    version at ``tols(float32)`` under the ``/f32_d128`` entries: K1 and
    K1-int8 at Llama's decode tick (8 rows, Hq = Hkv = 32, L 2048,
    positions spread) and at s = 5; K1-paged and K1-paged-int8 over
    shuffled, shared, null-tailed pools at s = 1 and 5 (called directly:
    the paged route sends s > 1 to K2-paged); K2-paged and K2-paged-int8
    at a suffix prefill and over the contiguous cache's identity view at
    pos 0 / 1024, those against the plain version in float64 (the float32
    one's distances beside) and to the same bits twice.  The library
    yardstick is SDPA at float32 (the row
    names the kernel it ran); the bound is max(bytes / 3.35 TB/s, FLOPs /
    165 TFLOP/s: three TF32 passes; over int8 K / V 247, two passes),
    ``bound_ms_cuda_cores`` at 67 beside."""
    from paddle_tpu_torch.ops import (cached_decode_attention,
                                      cached_decode_attention_reference,
                                      decode_attention_paged_cuda,
                                      decode_attention_paged_int8_cuda)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    f32 = torch.float32
    d = 128
    atol, rtol = tols(f32)

    def sdpa(q, k, v, mask):
        return lambda: TF.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    def cache_mask(pos, s, L):
        kj = torch.arange(L, device=dev)
        qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
        return (kj[None, None] <= qi[:, :, None])[:, None]     # B,1,s,L

    def plain(fn, *args):
        with reference_mode():
            return fn(*args)

    def row(base, shape, got, want, kfns, pfns, lfns, nbytes, ops, main,
            note=None, extra=None, truth=None):
        """``truth``: the plain version in float64, the row's yardstick in
        place of ``want`` (the float32 plain version's distances from it
        and from the kernel reported beside)."""
        torch.cuda.synchronize()
        extra = dict(extra or {})
        tol = f"atol {atol} + rtol {rtol}"
        if truth is not None:
            want, tol, vs = vs_f64(got, want, truth, tol)
            extra.update(vs)
        err = max_err(got, want)
        ok = (within(got, want, atol, rtol)
              and bool(torch.isfinite(got).all().item())
              and extra.get("deterministic", True))
        with reference_mode():
            plain_ms = time_ms(torch, pfns, budget_ms=PLAIN_BUDGET_MS)
        lib_ms = time_ms(torch, lfns)
        bms, by = bound(nbytes, ops, F32_I8_TC_FLOPS if base.endswith("_int8")
                        else F32_TC_FLOPS)
        record(base + F32_D128, shape, err, tol, ok, kfns, plain_ms, lib_ms,
               bms, by, main, note=note,
               extra=dict(extra, head_dim=d,
                          library_kernel=top_kernel(torch, lfns[0])))

    # ---- the K1 family: Llama's decode tick and a 5-token window ---------
    L, hq, hkv, b = F32_L, F32_HEADS, F32_HEADS, 8
    for s in (1, 5):
        pos_list = [min(p, L - s) for p in F32_TICK_POS]
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        mask = cache_mask(pos, s, L)
        live = [p + s for p in pos_list]
        ops = sum(4 * d * hq * (p + si + 1)
                  for p in pos_list for si in range(s))
        shape = (f"B={b} s={s} L={L} Hq={hq} Hkv={hkv} D={d} "
                 f"pos={pos_list} float32")
        n = copies(2 * b * L * hkv * d * 4)
        sets = [(randn(b, s, hq, d, dtype=f32), randn(b, L, hkv, d, dtype=f32),
                 randn(b, L, hkv, d, dtype=f32)) for _ in range(n)]
        q, kc, vc = sets[0]
        got = cached_decode_attention(q, kc, vc, pos)
        fns = [lambda t=t: cached_decode_attention(*t, pos) for t in sets]
        row("decode_attention", shape, got,
            plain(cached_decode_attention, q, kc, vc, pos),
            fns, fns, [sdpa(*t, mask) for t in sets],
            2 * b * s * hq * d * 4 + sum(live) * hkv * d * 4 * 2 + 4 * b,
            ops, s == 1, extra={"deterministic": bool(torch.equal(
                got, cached_decode_attention(q, kc, vc, pos)))})
        del sets, q, kc, vc, got

        # K1-int8: 128-token granules
        gr = 128
        sets = [(randn(b, s, hq, d, dtype=f32), int8_payload(b, L, hkv, d),
                 int8_payload(b, L, hkv, d), int8_scales(b, L // gr, hkv),
                 int8_scales(b, L // gr, hkv)) for _ in range(copies(
                     2 * b * L * hkv * d))]

        def run8(t):
            return cached_decode_attention(t[0], t[1], t[2], pos,
                                           k_scale=t[3], v_scale=t[4])
        deq = [(t[0], *((p.float().view(b, L // gr, gr, hkv, d)
                         * sc[:, :, None, :, None]).view(b, L, hkv, d)
                        for p, sc in ((t[1], t[3]), (t[2], t[4]))))
               for t in sets[:2]]
        got = run8(sets[0])
        fns = [lambda t=t: run8(t) for t in sets]
        row("decode_attention_int8", shape + f", int8 K/V granule {gr}",
            got, plain(run8, sets[0]), fns, fns,
            [sdpa(*t, mask) for t in deq],
            2 * b * s * hq * d * 4 + sum(live) * hkv * d * 2
            + sum(-(-x // gr) for x in live) * hkv * 4 * 2 + 4 * b, ops,
            s == 1, note=INT8_LIBRARY_NOTE,
            extra={"deterministic": bool(torch.equal(got, run8(sets[0])))})
        del sets, deq, got

        # K1-paged / K1-paged-int8: 128-token blocks, shuffled, two row
        # pairs sharing their first blocks, null dead tails
        bl, mb = 128, L // 128
        tables, n_blocks, live_keys = paged_layout(
            pos_list, s, bl, mb, ((1, 4, 8), (5, 3, 2)), seed=s)
        live_blocks = len({int(tables[r, j // bl])
                           for r, p in enumerate(pos_list)
                           for j in range(0, min(p + s, L), bl)})
        tables = torch.from_numpy(tables).to(dev)
        idx = tables.long()
        pshape = (f"B={b} s={s} Hq={hq} Hkv={hkv} D={d} block_len={bl} "
                  f"max_blocks={mb} pool={n_blocks} pos={pos_list} "
                  f"shared float32")
        for int8 in (False, True):
            if int8:
                sets = [(randn(b, s, hq, d, dtype=f32),
                         int8_payload(n_blocks, bl, hkv, d),
                         int8_payload(n_blocks, bl, hkv, d),
                         int8_scales(n_blocks, hkv),
                         int8_scales(n_blocks, hkv))
                        for _ in range(copies(2 * n_blocks * bl * hkv * d))]
            else:
                sets = [(randn(b, s, hq, d, dtype=f32),
                         randn(n_blocks, bl, hkv, d, dtype=f32),
                         randn(n_blocks, bl, hkv, d, dtype=f32))
                        for _ in range(copies(8 * n_blocks * bl * hkv * d))]

            # the K1-paged builds themselves: the paged route sends s > 1
            # to K2-paged (the verify window's rows of phase 2 do the same)
            def runp(t):
                if int8:
                    return decode_attention_paged_int8_cuda(
                        t[0], t[1], t[2], pos, tables, t[3], t[4])
                return decode_attention_paged_cuda(t[0], t[1], t[2], pos,
                                                   tables)

            def plainp(t):
                kw = dict(k_scale=t[3], v_scale=t[4]) if int8 else {}
                return cached_decode_attention_reference(
                    t[0], t[1], t[2], pos, block_tables=tables, **kw)

            def gathered(t):
                if not int8:
                    return (t[0], t[1][idx].reshape(b, L, hkv, d),
                            t[2][idx].reshape(b, L, hkv, d))
                return (t[0], *((p[idx].float() * sc[idx][:, :, None, :,
                                                          None]).reshape(
                    b, L, hkv, d) for p, sc in ((t[1], t[3]), (t[2], t[4]))))
            got = runp(sets[0])
            esz = 1 if int8 else 4
            row("decode_attention_paged" + ("_int8" if int8 else ""),
                pshape + (", int8 K/V" if int8 else ""), got,
                plainp(sets[0]), [lambda t=t: runp(t) for t in sets],
                [lambda t=t: plainp(t) for t in sets],
                [sdpa(*gathered(t), mask) for t in sets[:2]],
                2 * b * s * hq * d * 4 + live_keys * hkv * d * esz * 2
                + (live_blocks * hkv * 4 * 2 if int8 else 0)
                + 4 * b * (mb + 1), ops, s == 1,
                note=INT8_LIBRARY_NOTE if int8 else PAGED_LIBRARY_NOTE,
                extra={"deterministic": bool(torch.equal(got,
                                                         runp(sets[0])))})
            del sets, got

    # ---- K2-paged / K2-paged-int8: a suffix prefill of 4 rows x 512
    # queries at adopted prefix lengths (shuffled, shared, null-tailed
    # 128-token blocks), then the contiguous cache's identity view (one
    # 256-query chunk at pos 0 and 1024: 64-key blocks, int8 its
    # 128-token granules) ---------------------------------------------------
    b, s, hq, hkv, bl, mb = 4, 512, F32_HEADS, F32_HEADS, 128, F32_L // 128
    pos_list = [0, 128, 1024, 1536]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    tables, n_blocks, live_keys = paged_layout(pos_list, s, bl, mb,
                                               ((2, 3, 8), (0, 1, 1)), seed=4)
    live_blocks = len({int(tables[r, j // bl]) for r, p in enumerate(pos_list)
                       for j in range(0, min(p + s, F32_L), bl)})
    tables = torch.from_numpy(tables).to(dev)
    idx = tables.long()
    mask = cache_mask(pos, s, F32_L)
    ops = sum(4 * d * hq * (p + si + 1) for p in pos_list for si in range(s))
    for int8 in (False, True):
        if int8:
            sets = [(randn(b, s, hq, d, dtype=f32),
                     int8_payload(n_blocks, bl, hkv, d),
                     int8_payload(n_blocks, bl, hkv, d),
                     int8_scales(n_blocks, hkv), int8_scales(n_blocks, hkv))
                    for _ in range(2)]
        else:
            sets = [(randn(b, s, hq, d, dtype=f32),
                     randn(n_blocks, bl, hkv, d, dtype=f32),
                     randn(n_blocks, bl, hkv, d, dtype=f32))
                    for _ in range(2)]

        def runp(t):
            kw = dict(k_scale=t[3], v_scale=t[4]) if int8 else {}
            return cached_decode_attention(t[0], t[1], t[2], pos,
                                           block_tables=tables, **kw)

        def gathered(t):
            if not int8:
                return (t[0], t[1][idx].reshape(b, F32_L, hkv, d),
                        t[2][idx].reshape(b, F32_L, hkv, d))
            return (t[0], *((p[idx].float() * sc[idx][:, :, None, :, None])
                            .reshape(b, F32_L, hkv, d)
                            for p, sc in ((t[1], t[3]), (t[2], t[4]))))
        fns = [lambda t=t: runp(t) for t in sets]
        esz = 1 if int8 else 4
        base = "flash_attention_fwd_paged" + ("_int8" if int8 else "")
        got = runp(sets[0])
        row(base, f"B={b} s={s} Hq={hq} Hkv={hkv} D={d} block_len={bl} "
            f"max_blocks={mb} pool={n_blocks} pos={pos_list} shared "
            f"float32" + (", int8 K/V" if int8 else ""), got,
            plain(runp, sets[0]), fns, fns,
            [sdpa(*gathered(t), mask) for t in sets],
            2 * b * s * hq * d * 4 + live_keys * hkv * d * esz * 2
            + (live_blocks * hkv * 4 * 2 if int8 else 0) + 4 * b * (mb + 1),
            ops, True, note=INT8_LIBRARY_NOTE if int8 else PAGED_LIBRARY_NOTE,
            extra={"deterministic": bool(torch.equal(got, runp(sets[0])))},
            truth=plain(runp, as_f64(sets[0])))
        del sets, got

        # the identity view: a 2-row cache, row 1's 256-query chunk
        nrow, gr, s_c = 2, 128, 256
        for p in (0, 1024):
            if int8:
                cache = (int8_payload(nrow, F32_L, hkv, d),
                         int8_payload(nrow, F32_L, hkv, d),
                         int8_scales(nrow, F32_L // gr, hkv),
                         int8_scales(nrow, F32_L // gr, hkv))
            else:
                cache = (randn(nrow, F32_L, hkv, d, dtype=f32),
                         randn(nrow, F32_L, hkv, d, dtype=f32))
            q = randn(1, s_c, hq, d, dtype=f32)
            cpos = torch.tensor([p], dtype=torch.int32, device=dev)
            rows = torch.tensor([1], dtype=torch.int32, device=dev)

            def runi(c=cache):
                kw = dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
                return cached_decode_attention(q, c[0], c[1], cpos,
                                               rows=rows, **kw)
            if int8:
                dense = [(x[1:2].float().view(1, F32_L // gr, gr, hkv, d)
                          * sc[1:2, :, None, :, None]).view(1, F32_L, hkv, d)
                         for x, sc in ((cache[0], cache[2]),
                                       (cache[1], cache[3]))]
            else:
                dense = [cache[0][1:2], cache[1][1:2]]
            n = p + s_c
            c64 = as_f64(cache)
            got = runi()
            row(base, f"identity view: cache B={nrow} L={F32_L} Hq={hq} "
                f"Hkv={hkv} D={d} block_len={gr if int8 else 64}, row 1, "
                f"s={s_c} pos={p} float32" + (", int8 K/V" if int8 else ""),
                got, plain(runi), [runi], [runi],
                [sdpa(q, dense[0][:, :n], dense[1][:, :n],
                      cache_mask(cpos, s_c, n))],
                2 * s_c * hq * d * 4 + n * hkv * d * esz * 2
                + (-(-n // gr) * hkv * 8 if int8 else 0),
                sum(4 * d * hq * (p + si + 1) for si in range(s_c)), False,
                note=INT8_LIBRARY_NOTE if int8 else PAGED_LIBRARY_NOTE,
                extra={"deterministic": bool(torch.equal(got, runi()))},
                truth=plain(lambda: cached_decode_attention(
                    q.double(), c64[0], c64[1], cpos, rows=rows,
                    **(dict(k_scale=c64[2], v_scale=c64[3]) if int8
                       else {}))))
            del cache, dense, c64, got


# Llama-2-7B's attention (serving_f16): 32 query heads, 32 KV heads
L27_HEADS = 32
# phase 2's float16 head dims: Llama-2-7B's 128, the narrow and wide tiles
# and ring rows (64, 256), and D % 16 == 8 on both (72, 136: the int8
# builds' 8-byte copies and K2-paged-int8's CP8 staging)
F16_DIMS = (64, 72, 128, 136, 256)
# TinyLlama-1.1B's attention (serving_tinyllama): 32 query heads, 4 KV heads
TL_HEADS, TL_KV_HEADS = 32, 4
# phase 2's bf16 head dims below 128: the tiny config's 16, TinyLlama's 64,
# DiT's 72 (D % 16 == 8: the int8 builds' 8-byte copies), and 96
BF16_SMALL_DIMS = (16, 64, 72, 96)
# the head dims of the /bf16_d256 rows: 136 and 200 (int8 rows of D % 16
# == 8 bytes: K1's 8-byte copies, K2-paged-int8's CP8 staging), 192, 256
BF16_WIDE_DIMS = (136, 192, 200, 256)
# the head dims of the /f32 rows: TinyLlama's 64, 72 (D % 16 == 8: the
# int8 rows of 72 bytes, the split K5 / K6's odd chunk) and 96 at
# TinyLlama's heads, then the wide ones at a Gemma-2B-wide Llama's
F32_SMALL_DIMS = (64, 72, 96)
F32_WIDE_DIMS = BF16_WIDE_DIMS
# a Llama at Gemma-2B's widths: 8 query heads over one KV head
G2B_HEADS, G2B_KV_HEADS = 8, 1


def phase_bf16_head_dim_rows(torch, record, randn, int8_payload, int8_scales,
                             tols, wide=False, f16=False, f32=False):
    """Phase 2's rows of every bf16 build of K1 and K2-paged below head_dim
    128, each held against its plain version at ``tols(bfloat16)`` under
    the ``/bf16_d64`` entries (``head_dim`` on each row), at D 16, 64, 72
    and 96, each build called directly: K1, K1-int8 (128-token granules),
    K1-paged and K1-paged-int8 (shuffled, shared, null-tailed pools of
    64-token blocks) at TinyLlama's decode tick (8 rows, Hq 32, Hkv 4, L
    2048, positions spread; at D 64 also the verify window s = 5), the K1
    rows checking the same bits on a second call; K2-paged and
    K2-paged-int8 at a suffix prefill of 4 rows x 512 queries over a
    2048-key pool of 64-token blocks.  Contract rows at every D: K1 at s =
    5 with row 0 at pos -3 (its first 3 queries see no key: exactly 0),
    K1-int8 over 8-token scale granules and K1-paged(-int8) over 16-token
    blocks (a 16-key slice spans two), K2-paged(-int8) at 130 queries
    (two q tiles) with row 0 at pos -1 (query 0 sees no key).  At D 72 the
    int8 rows take the 8-byte copies (an int8 row of 72 bytes starts only
    8-byte aligned).  The library yardstick of the main rows is SDPA
    (enable_gqa) over the whole (or pre-gathered, dequantized) cache; the
    bound is max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s).

    ``wide``: the same rows under the ``/bf16_d256`` entries at D 136, 192,
    200 and 256 (136 and 200: the 8-byte int8 copies and K2-paged-int8's
    CP8 staging) at a Gemma-2B-wide Llama's heads (8 over 1; the verify
    window s = 5 at D 256), then K2 over contiguous K/V (:func:`k2_rows`):
    the serving wave (B 4 x 2048, causal GQA) and dead rows (Sq 77 over
    Skv 61) at every D, at D 256 not causal, packed documents and Sq 64
    over Skv 256; the identity view and its crossover with K1
    (:func:`phase_identity_rows`); and K5 / K6 on their 256-wide tiles
    (:func:`k5_k6_rows`, ``flash_attention_bwd_*/bf16_d256`` entries) at
    every D: the training micro-batch's shape B 4 x 2048 causal (the main
    row at D 256), Sq 77 over Skv 61 (dead rows), packed documents at S
    2048, the ring hop (Sq 256, Skv 512), not causal at B 4 x 512 and Sq
    64 over Skv 256.

    ``f16``: the forward rows at float16 under the ``/f16`` entries at D
    64, 72, 128, 136 and 256 (72 and 136: the 8-byte int8 copies, the CP8
    staging and the PAD instances) at Llama-2-7B's heads (32 over 32; the
    main rows and the verify window at D 128), then K2 at the serving wave
    (B 4 x 2048) and dead rows (Sq 77 over Skv 61) at every D, packed
    documents, the ring hop and not causal at D 128, the identity view at
    pos 0 and 1024, and K5 / K6 (:func:`k5_k6_rows`, the ``/f16`` entries
    ``flash_attention_bwd_*/f16``) at every D: B 4 x 2048 causal (the
    main row at D 128), Sq 77 over Skv 61 (dead rows), packed documents
    at S 2048, the ring hop (Sq 256, Skv 512) and not causal at B 4 x
    512.

    ``f32``: the rows at float32 under the ``/f32`` entries at
    ``tols(float32)``, at D 64, 72 and 96 (TinyLlama's heads, 32 over 4)
    or, ``wide``, 136, 192, 200 and 256 (a Gemma-2B-wide Llama's, 8 over
    1), the verify window s = 5 at D 64 and 256, the contract rows'
    K2-paged over 16-token blocks (the float32 kernel takes any
    block_len); then K2 at the serving wave (B 4 x 2048 causal GQA) and
    dead rows (Sq 77 over Skv 61) at every D, packed documents and the
    ring hop at D 64 and 256; the identity view at D 64 and 256; and K5 /
    K6 at every D at Sq 77 over Skv 61 (dead rows), the ring hop and not
    causal (B 4 x 512), and the training micro-batch's shapes, B 2 x 2048
    packed and B 4 x 2048 causal (the main rows at D 256).  Every K2 /
    K2-paged(-int8) and K5 / K6 row is held against the plain version in
    float64 (``max_err_vs_f32_plain`` beside), the K2-paged rows also to
    the same bits twice.  The bound is max(bytes / 3.35 TB/s, FLOPs / 165
    TFLOP/s: float32 products in three TF32 passes; over int8 K / V 247,
    two passes), the CUDA cores' 67 TFLOP/s beside as
    ``bound_ms_cuda_cores``."""
    from paddle_tpu_torch.ops import (cached_decode_attention_reference,
                                      decode_attention_cuda,
                                      decode_attention_int8_cuda,
                                      decode_attention_paged_cuda,
                                      decode_attention_paged_int8_cuda,
                                      flash_attention_fwd_paged_cuda,
                                      flash_attention_fwd_paged_int8_cuda)
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    # the rows' dtype, its name in the rows, its bytes and peak rate
    bf16 = (torch.float16 if f16 else torch.float32 if f32
            else torch.bfloat16)
    tname = "float16" if f16 else "float32" if f32 else "bf16"
    esz, peak = (4, F32_TC_FLOPS) if f32 else (2, BF16_FLOPS)
    atol, rtol = tols(bf16)
    if f16:
        suffix, dims, main_d = F16, F16_DIMS, 128
        hq = hkv = L27_HEADS
    else:
        suffix = F32 if f32 else BF16_D256 if wide else BF16_D64
        dims = ((F32_WIDE_DIMS if wide else F32_SMALL_DIMS) if f32
                else BF16_WIDE_DIMS if wide else BF16_SMALL_DIMS)
        main_d = 256 if wide else 64
        hq, hkv = ((G2B_HEADS, G2B_KV_HEADS) if wide
                   else (TL_HEADS, TL_KV_HEADS))

    def randn(*shape, dtype=bf16, _randn=randn):
        return _randn(*shape, dtype=dtype)

    def sdpa(q, k, v, mask):
        return lambda: TF.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    def cache_mask(pos, s, n):
        kj = torch.arange(n, device=dev)
        qi = pos.long()[:, None] + torch.arange(s, device=dev)[None]
        return (kj[None, None] <= qi[:, :, None])[:, None]     # B,1,s,n

    def row(name, d, shape, fn, plain, sets, lib, nbytes, ops, main,
            dead=None, same_bits=False, note=None):
        """Hold ``fn`` against ``plain`` on ``sets[0]`` and record the
        row; ``dead`` (row, queries): those first queries of that row see
        no key and must be exactly 0; ``lib``: the library's calls (None:
        not timed)."""
        got, want = fn(sets[0]), plain(sets[0])
        extra = {"head_dim": d}
        tol = f"atol {atol} + rtol {rtol}"
        if f32 and name.startswith("flash_attention_fwd"):
            # the float32 K2 family's yardstick: the plain version in
            # float64, the float32 one's distances beside
            want, tol, vs = vs_f64(got, want, plain(as_f64(sets[0])), tol)
            extra.update(vs)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = within(got, want, atol, rtol) and bool(
            torch.isfinite(got).all().item())
        if dead is not None:
            extra["dead_queries_zero"] = bool(
                (got[dead[0], :dead[1]] == 0).all().item())
            ok = ok and extra["dead_queries_zero"]
            tol += ", queries that see no key exactly 0"
        if same_bits:
            extra["deterministic"] = bool(torch.equal(got, fn(sets[0])))
            ok = ok and extra["deterministic"]
            tol += ", the same bits twice"
        plain_ms = time_ms(torch, [lambda t=t: plain(t) for t in sets],
                           budget_ms=PLAIN_BUDGET_MS)
        lib_ms = time_ms(torch, lib) if lib else None
        # float16's peak is bf16's; float32 q over int8 K / V: two passes
        bms, by = bound(nbytes, ops, F32_I8_TC_FLOPS
                        if f32 and name.endswith("_int8") else peak)
        record(name + suffix, shape, err, tol, ok,
               [lambda t=t: fn(t) for t in sets], plain_ms, lib_ms, bms,
               by, main, note=note, extra=extra)

    def dequant(payload, sc, gran):
        """An int8 (B, L, H, D) cache times its (B, L / gran, H) scales."""
        b, n, h, d = payload.shape
        return (payload.float().view(b, n // gran, gran, h, d)
                * sc[:, :, None, :, None]).view(b, n, h, d).to(bf16)

    def gathered(t, idx, int8):
        """A paged set's pool gathered through the table (int8:
        dequantized) into a contiguous bf16 (B, L, H, D) copy."""
        b, mb = idx.shape
        if not int8:
            return (t[0], *(p[idx].reshape(b, -1, *p.shape[2:])
                            for p in (t[1], t[2])))
        return (t[0], *((p[idx].float() * sc[idx][:, :, None, :, None])
                        .reshape(b, -1, *p.shape[2:]).to(bf16)
                        for p, sc in ((t[1], t[3]), (t[2], t[4]))))

    def k1_family(d, b, s, L, pos_list, gran, bl, share, main, contract):
        """K1, K1-int8 (``gran``-token granules), K1-paged and
        K1-paged-int8 (``bl``-token blocks) at one shape."""
        mb = L // bl
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        live = [max(0, min(p + s, L)) for p in pos_list]
        ops = sum(4 * d * hq * max(0, min(p + si + 1, L))
                  for p in pos_list for si in range(s))
        io = 2 * b * s * hq * d * esz + 4 * b
        dead = ((0, -pos_list[0]) if pos_list[0] < 0 else None)
        mask = cache_mask(pos, s, L)
        shape = (f"B={b} s={s} L={L} Hq={hq} Hkv={hkv} D={d} "
                 f"pos={pos_list} {tname}")
        sets = [(randn(b, s, hq, d), randn(b, L, hkv, d), randn(b, L, hkv, d))
                for _ in range(copies(4 * b * L * hkv * d))]
        row("decode_attention", d, shape,
            lambda t: decode_attention_cuda(t[0], t[1], t[2], pos),
            lambda t: cached_decode_attention_reference(t[0], t[1], t[2],
                                                        pos),
            sets, None if contract else [sdpa(*t, mask) for t in sets],
            io + sum(live) * hkv * d * esz * 2, ops, main, dead=dead,
            same_bits=True)
        del sets
        n_gran = L // gran
        sets = [(randn(b, s, hq, d), int8_payload(b, L, hkv, d),
                 int8_payload(b, L, hkv, d), int8_scales(b, n_gran, hkv),
                 int8_scales(b, n_gran, hkv))
                for _ in range(copies(2 * b * L * hkv * d))]
        lib = None if contract else [
            sdpa(t[0], dequant(t[1], t[3], gran), dequant(t[2], t[4], gran),
                 mask) for t in sets[:2]]
        row("decode_attention_int8", d, shape + f", int8 K/V granule {gran}",
            lambda t: decode_attention_int8_cuda(t[0], t[1], t[2], pos,
                                                 t[3], t[4]),
            lambda t: cached_decode_attention_reference(
                t[0], t[1], t[2], pos, k_scale=t[3], v_scale=t[4]),
            sets, lib, io + sum(live) * hkv * d * 2
            + sum(-(-x // gran) for x in live) * hkv * 4 * 2, ops, main,
            dead=dead, same_bits=True, note=INT8_LIBRARY_NOTE)
        del sets, lib
        tables, n_blocks, live_keys = paged_layout(pos_list, s, bl, mb,
                                                   share, seed=d + s)
        live_blocks = len({int(tables[r, j // bl])
                           for r, p in enumerate(pos_list)
                           for j in range(0, max(0, min(p + s, L)), bl)})
        tables = torch.from_numpy(tables).to(dev)
        idx = tables.long()
        pshape = (f"B={b} s={s} Hq={hq} Hkv={hkv} D={d} block_len={bl} "
                  f"max_blocks={mb} pool={n_blocks} pos={pos_list} shared "
                  f"{tname}")
        for int8 in (False, True):
            if int8:
                sets = [(randn(b, s, hq, d),
                         int8_payload(n_blocks, bl, hkv, d),
                         int8_payload(n_blocks, bl, hkv, d),
                         int8_scales(n_blocks, hkv),
                         int8_scales(n_blocks, hkv))
                        for _ in range(copies(2 * n_blocks * bl * hkv * d))]
            else:
                sets = [(randn(b, s, hq, d),
                         randn(n_blocks, bl, hkv, d),
                         randn(n_blocks, bl, hkv, d))
                        for _ in range(copies(4 * n_blocks * bl * hkv * d))]

            def runp(t, int8=int8):
                if int8:
                    return decode_attention_paged_int8_cuda(
                        t[0], t[1], t[2], pos, tables, t[3], t[4])
                return decode_attention_paged_cuda(t[0], t[1], t[2], pos,
                                                   tables)

            def plainp(t, int8=int8):
                kw = dict(k_scale=t[3], v_scale=t[4]) if int8 else {}
                return cached_decode_attention_reference(
                    t[0], t[1], t[2], pos, block_tables=tables, **kw)
            lib = None if contract else [sdpa(*gathered(t, idx, int8), mask)
                                         for t in sets[:2]]
            row("decode_attention_paged" + ("_int8" if int8 else ""), d,
                pshape + (", int8 K/V" if int8 else ""), runp, plainp, sets,
                lib, io + live_keys * hkv * d * (1 if int8 else esz) * 2
                + (live_blocks * hkv * 4 * 2 if int8 else 0)
                + 4 * b * mb, ops, main, dead=dead, same_bits=True,
                note=INT8_LIBRARY_NOTE if int8 else PAGED_LIBRARY_NOTE)
            del sets, lib

    def k2_paged(d, b, s, bl, mb, pos_list, share, main, contract):
        """K2-paged and K2-paged-int8: a suffix prefill of ``s`` queries
        at per-row ``pos_list`` over ``bl``-token blocks."""
        L = mb * bl
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        tables, n_blocks, live_keys = paged_layout(pos_list, s, bl, mb,
                                                   share, seed=d)
        live_blocks = len({int(tables[r, j // bl])
                           for r, p in enumerate(pos_list)
                           for j in range(0, max(0, min(p + s, L)), bl)})
        tables = torch.from_numpy(tables).to(dev)
        idx = tables.long()
        mask = cache_mask(pos, s, L)
        ops = sum(4 * d * hq * max(0, min(p + si + 1, L))
                  for p in pos_list for si in range(s))
        dead = (0, -pos_list[0]) if pos_list[0] < 0 else None
        for int8 in (False, True):
            if int8:
                sets = [(randn(b, s, hq, d),
                         int8_payload(n_blocks, bl, hkv, d),
                         int8_payload(n_blocks, bl, hkv, d),
                         int8_scales(n_blocks, hkv),
                         int8_scales(n_blocks, hkv)) for _ in range(2)]
            else:
                sets = [(randn(b, s, hq, d), randn(n_blocks, bl, hkv, d),
                         randn(n_blocks, bl, hkv, d)) for _ in range(2)]

            def runp(t, int8=int8):
                if int8:
                    return flash_attention_fwd_paged_int8_cuda(
                        t[0], t[1], t[2], pos, tables, t[3], t[4])
                return flash_attention_fwd_paged_cuda(t[0], t[1], t[2], pos,
                                                      tables)

            def plainp(t, int8=int8):
                kw = dict(k_scale=t[3], v_scale=t[4]) if int8 else {}
                return cached_decode_attention_reference(
                    t[0], t[1], t[2], pos, block_tables=tables, **kw)
            lib = None if contract else [sdpa(*gathered(t, idx, int8), mask)
                                         for t in sets]
            row("flash_attention_fwd_paged" + ("_int8" if int8 else ""), d,
                f"B={b} s={s} Hq={hq} Hkv={hkv} D={d} block_len={bl} "
                f"max_blocks={mb} pool={n_blocks} pos={pos_list} shared "
                f"{tname}" + (", int8 K/V" if int8 else ""), runp, plainp,
                sets,
                lib, 2 * b * s * hq * d * esz
                + live_keys * hkv * d * (1 if int8 else esz) * 2
                + (live_blocks * hkv * 4 * 2 if int8 else 0)
                + 4 * b * (mb + 1), ops, main, dead=dead, same_bits=f32,
                note=INT8_LIBRARY_NOTE if int8 else PAGED_LIBRARY_NOTE)
            del sets, lib

    # the forward rows' main D (the /f32 entries take theirs at D 64)
    fwd_main = None if f32 and wide else main_d
    for d in dims:
        # the decode tick (at the main D its verify window too), then the
        # contract rows
        for s in ((1, 5) if d == main_d else (1,)):
            k1_family(d, 8, s, F32_L, [min(p, F32_L - s)
                                       for p in F32_TICK_POS], 128, 64,
                      ((1, 4, 8), (5, 3, 2)), d == fwd_main and s == 1,
                      False)
        k1_family(d, 4, 5, 1024, [-3, 7, 300, 1019], 8, 16, ((1, 2, 4),),
                  False, True)
        k2_paged(d, 4, 512, 64, F32_L // 64, [0, 128, 1024, 1536],
                 ((2, 3, 8), (0, 1, 1)), d == fwd_main, False)
        # 130 queries (two q tiles) over a 1024-key table; float32 at an
        # odd block_len, 16, which the 16-bit kernel refuses
        bl = 16 if f32 else 64
        k2_paged(d, 3, 130, bl, 1024 // bl, [-1, 0, 700], ((1, 2, 3),),
                 False, True)
    if f32:
        k2 = "flash_attention_fwd" + F32
        k2_rows(torch, record, randn, tols,
                [(k2, bf16, 4, F32_L, F32_L, hq, hkv, d, True, None,
                  d == 256) for d in dims]
                + [(k2, bf16, 2, 77, 61, hq, hkv, d, True, None, False)
                   for d in dims]
                + [(k2, bf16, 2, F32_L, F32_L, hq, hkv, main_d, True,
                    "packed", False),
                   (k2, bf16, 2, 256, 512, hq, hkv, main_d, True, "ring",
                    False)])
        phase_identity_rows(torch, record, randn, int8_payload, int8_scales,
                            tols, f32=main_d)
        # and the training micro-batch's shapes at every D (ROADMAP C6:
        # dk / dv summed over G x Sq terms, held at 1e-5 of float64)
        k5_k6_rows(torch, record, randn, tols, [
            (F32_BWD, bf16, b, sq, skv, hq, hkv, d, causal, segments,
             d == 256 and segments is None and sq == F32_L)
            for d in dims
            for b, sq, skv, causal, segments in (
                (2, 77, 61, True, None),
                (2, 256, 512, True, "ring"),
                (4, 512, 512, False, None),
                (2, F32_L, F32_L, True, "packed"),
                (4, F32_L, F32_L, True, None))])
        return
    if f16:
        k2 = "flash_attention_fwd" + F16
        k2_rows(torch, record, randn, tols,
                [(k2, bf16, 4, F32_L, F32_L, hq, hkv, d, True, None,
                  d == main_d) for d in dims]
                + [(k2, bf16, 2, 77, 61, hq, hkv, d, True, None, False)
                   for d in dims]
                + [(k2, bf16, 2, F32_L, F32_L, hq, hkv, main_d, True,
                    "packed", False),
                   (k2, bf16, 2, 256, 512, hq, hkv, main_d, True, "ring",
                    False),
                   (k2, bf16, 4, 512, 512, hq, hkv, main_d, False, None,
                    False)])
        phase_identity_rows(torch, record, randn, int8_payload, int8_scales,
                            tols, f16=True)
        k5_k6_rows(torch, record, randn, tols, [
            (F16_BWD, bf16, b, sq, skv, hq, hkv, d, causal, segments,
             main and d == main_d)
            for d in dims
            for b, sq, skv, causal, segments, main in (
                (4, F32_L, F32_L, True, None, True),
                (2, 77, 61, True, None, False),
                (2, F32_L, F32_L, True, "packed", False),
                (2, 256, 512, True, "ring", False),
                (4, 512, 512, False, None, False))])
        return
    if not wide:
        return

    k2 = "flash_attention_fwd" + BF16_D256
    k2_rows(torch, record, randn, tols,
            [(k2, bf16, 4, F32_L, F32_L, hq, hkv, d, True, None, d == main_d)
             for d in dims]
            + [(k2, bf16, 2, 77, 61, hq, hkv, d, True, None, False)
               for d in dims]
            + [(k2, bf16, 4, 512, 512, hq, hkv, main_d, False, None, False),
               (k2, bf16, 2, F32_L, F32_L, hq, hkv, main_d, True, "packed",
                False),
               (k2, bf16, 4, 64, 256, hq, hkv, main_d, False, None, False)])
    phase_identity_rows(torch, record, randn, int8_payload, int8_scales,
                        tols, wide=True)
    # K5 / K6 on 256-wide tiles: the training micro-batch's shape (B 4 x
    # 2048 causal, the main row at D 256), dead rows, packed documents, the
    # ring hop, not causal, Sq 64 over Skv 256, at every D
    k5_k6_rows(torch, record, randn, tols, [
        (BF16_D256_BWD, bf16, b, sq, skv, hq, hkv, d, causal, segments,
         main and d == main_d)
        for b, sq, skv, causal, segments, main in (
            (4, F32_L, F32_L, True, None, True),
            (2, 77, 61, True, None, False),
            (2, F32_L, F32_L, True, "packed", False),
            (2, 256, 512, True, "ring", False),
            (4, 512, 512, False, None, False),
            (4, 64, 256, False, None, False))
        for d in dims])


def phase_f16_rows(torch, record, randn, int8_payload, int8_scales, tols):
    """Phase 2's float16 rows (the ``/f16`` entries): the int8 -> float16
    converters of K1 / K2 and of K4 against a table of all 256 bytes
    (``int8_tables`` line, beside the bf16 ones); every forward build at D
    64, 72, 128, 136 and 256 (:func:`phase_bf16_head_dim_rows` with
    ``f16``); then the range rows, where float16's 5 exponent bits (largest
    65504, smallest normal 6.1e-5) differ from bf16's 8: K1 and K2 with
    scores near +-30 and V entries near 1e3, and K1-int8, K1-paged-int8
    and K2-paged-int8 with V scales near 1e-4 (P times such a scale is
    float16-subnormal: the kernels apply it relative to the tile's
    largest, in float32, as the reference scales the float32 P.V product),
    each held at 2e-3 of its largest output (outputs near 1e-2 would pass
    any atol of 2e-3); and K5 / K6's range rows at D 128 and 256
    (:func:`bwd_range_row`: a loss-scaled dO whose dS passes 65504)."""
    import ctypes
    from paddle_tpu_torch.ops import (cached_decode_attention_reference,
                                      decode_attention_cuda,
                                      decode_attention_int8_cuda,
                                      decode_attention_paged_int8_cuda,
                                      flash_attention_fwd_cuda,
                                      flash_attention_fwd_paged_int8_cuda,
                                      flash_attention_reference)
    from paddle_tpu_torch.ops.cuda import _build, stream_ptr

    dev = torch.device("cuda")
    f16 = torch.float16
    byte = torch.arange(256, device=dev).to(torch.uint8).view(torch.int8)
    # K4's converter returns the pairs {4i, 4i + 2}, {4i + 1, 4i + 3}
    pairs = torch.tensor([j for i in range(64)
                          for j in (4 * i, 4 * i + 2, 4 * i + 1, 4 * i + 3)],
                         device=dev)
    tables = {}
    for lib, fn, order in (
            ("decode_attention", "decode_attention_int8_table", None),
            ("int8_matmul", "int8_matmul_int8_table", pairs)):
        for dt, name in ((torch.bfloat16, lib), (f16, lib + "_f16")):
            entry = getattr(_build.load(name), fn)
            entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            entry.restype = ctypes.c_int
            out = torch.zeros(256, dtype=dt, device=dev)
            _build.check(_build.load(name), lib,
                         entry(out.data_ptr(), stream_ptr(dev)))
            want = (byte if order is None else byte[order]).to(dt)
            torch.cuda.synchronize()
            tables[name] = bool(torch.equal(out, want))
    emit({"phase": "int8_tables", "bytes": 256, "exact": tables})
    check(all(tables.values()), f"an int8 converter is not exact: {tables}")

    phase_bf16_head_dim_rows(torch, record, randn, int8_payload,
                             int8_scales, tols, f16=True)

    def range_row(name, shape, fn, plain, nbytes, ops):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, top = max_err(got, want), float(want.float().abs().max())
        ok = err <= 2e-3 * top and bool(torch.isfinite(got).all().item())
        bms, by = bound(nbytes, ops, BF16_FLOPS)
        record(name + F16, "range: " + shape, err,
               f"2e-3 of the largest output ({top})", ok, [fn],
               time_ms(torch, [plain], budget_ms=PLAIN_BUDGET_MS), None,
               bms, by, False, extra={"head_dim": 128, "max_abs_out": top})

    d, h, b, L = 128, 8, 4, 2048
    pos = torch.tensor([2047, 1000, 17, 1536], dtype=torch.int32, device=dev)
    ops = sum(4 * d * h * (p + 1) for p in (2047, 1000, 17, 1536))
    # scores near +-30 (q and k of std 3: q.k / sqrt(128) of std 9) and V
    # entries near 1e3
    q = 3 * randn(b, 1, h, d, dtype=f16)
    k = 3 * randn(b, L, h, d, dtype=f16)
    v = 1e3 * randn(b, L, h, d, dtype=f16)
    range_row("decode_attention", f"B={b} s=1 L={L} Hq=Hkv={h} D={d} "
              "float16, q and k of std 3, v of std 1e3",
              lambda: decode_attention_cuda(q, k, v, pos),
              lambda: cached_decode_attention_reference(q, k, v, pos),
              2 * b * L * h * d * 2, ops)
    qw = 3 * randn(2, 512, h, d, dtype=f16)
    kw_, vw = k[:2, :512].contiguous(), v[:2, :512].contiguous()
    range_row("flash_attention_fwd", f"B=2 Sq=Skv=512 Hq=Hkv={h} D={d} "
              "causal float16, q and k of std 3, v of std 1e3",
              lambda: flash_attention_fwd_cuda(qw, kw_, vw, causal=True)[0],
              lambda: flash_attention_reference(qw, kw_, vw,
                                                causal=True)[0],
              4 * 2 * 512 * h * d * 2, 2 * d * h * 2 * 512 * 513)
    del q, k, v, qw, kw_, vw
    # V scales near 1e-4 (K's as phase 2's)
    q = randn(b, 1, h, d, dtype=f16)
    k8, v8 = int8_payload(b, L, h, d), int8_payload(b, L, h, d)
    ks, vs = int8_scales(b, L // 128, h), 1e-4 * (
        0.5 + torch.rand(b, L // 128, h, device=dev))
    range_row("decode_attention_int8", f"B={b} s=1 L={L} Hq=Hkv={h} D={d} "
              "float16 q, int8 K/V granule 128, V scales near 1e-4",
              lambda: decode_attention_int8_cuda(q, k8, v8, pos, ks, vs),
              lambda: cached_decode_attention_reference(
                  q, k8, v8, pos, k_scale=ks, v_scale=vs),
              2 * b * L * h * d, ops)
    bl = 64
    nblk = b * L // bl
    table = torch.randperm(nblk, device=dev).int().view(b, L // bl)
    kp, vp = k8.view(nblk, bl, h, d), v8.view(nblk, bl, h, d)
    pks, pvs = int8_scales(nblk, h), 1e-4 * (
        0.5 + torch.rand(nblk, h, device=dev))
    range_row("decode_attention_paged_int8",
              f"B={b} s=1 block_len={bl} Hq=Hkv={h} D={d} float16 q, int8 "
              "K/V, V scales near 1e-4",
              lambda: decode_attention_paged_int8_cuda(q, kp, vp, pos, table,
                                                       pks, pvs),
              lambda: cached_decode_attention_reference(
                  q, kp, vp, pos, block_tables=table, k_scale=pks,
                  v_scale=pvs), 2 * b * L * h * d, ops)
    qp = randn(b, 256, h, d, dtype=f16)
    pos2 = torch.tensor([0, 512, 1024, 1792], dtype=torch.int32, device=dev)
    range_row("flash_attention_fwd_paged_int8",
              f"B={b} s=256 block_len={bl} Hq=Hkv={h} D={d} float16 q, int8 "
              "K/V, V scales near 1e-4",
              lambda: flash_attention_fwd_paged_int8_cuda(
                  qp, kp, vp, pos2, table, pks, pvs),
              lambda: cached_decode_attention_reference(
                  qp, kp, vp, pos2, block_tables=table, k_scale=pks,
                  v_scale=pvs), 2 * b * L * h * d,
              sum(4 * d * h * (p + i + 1) for p in (0, 512, 1024, 1792)
                  for i in range(256)))
    del q, k8, v8, kp, vp, qp
    for d in (128, 256):
        bwd_range_row(torch, randn, record, d)


def phase_f32_rows(torch, record, randn, int8_payload, int8_scales, tols):
    """Phase 2's float32 rows past the first float32 instances (the
    ``/f32`` entries, :func:`phase_bf16_head_dim_rows` with ``f32``): every
    build at D 64, 72 and 96 at TinyLlama's heads, then at D 136, 192, 200
    and 256 at a Gemma-2B-wide Llama's."""
    for wide in (False, True):
        phase_bf16_head_dim_rows(torch, record, randn, int8_payload,
                                 int8_scales, tols, wide=wide, f32=True)


def bwd_range_row(torch, randn, record, d, b=2, s=512, h=8):
    """K5 / K6's range rows at float16 (the ``/f16`` entries), causal B x S
    with h heads at head_dim ``d``: dO near 3e2 (a loss-scaled gradient),
    V near 1e3, Q and K near 1e-2, so that scores are near 0, P near 1 /
    (visible keys), and |dS| = |P (dP - delta) scale| passes float16's
    65504 on the first queries of the causal triangle while the plain
    version's dq, dk and dv stay finite.  Each kernel's outputs must be
    finite wherever the plain version's are, and within 2e-3 of their
    largest; the row prints the largest |dS| it reached."""
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_reference,
                                      flash_attention_fwd_cuda)
    from paddle_tpu_torch.ops._dispatch import reference_mode

    f16 = torch.float16
    q, k = (1e-2 * randn(b, s, h, d, dtype=f16) for _ in range(2))
    v = 1e3 * randn(b, s, h, d, dtype=f16)
    do = 3e2 * randn(b, s, h, d, dtype=f16)
    out, lse = flash_attention_fwd_cuda(q, k, v, causal=True)
    delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
             .contiguous())
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
    # the plain version's dS, for its largest magnitude
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * d ** -0.5
                  - lse[..., None]).masked_fill(~keep, 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf)
              - delta[..., None]) * d ** -0.5
    max_ds = float(ds.abs().max())
    del qf, kf, vf, dof, p, ds
    with reference_mode():
        plain_ms = time_ms(torch, [lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=True)], budget_ms=PLAIN_BUDGET_MS)
    pairs = b * s * (s + 1) // 2
    shape = (f"range: B={b} S={s} Hq=Hkv={h} D={d} causal float16, dO of "
             f"std 3e2, V of std 1e3, Q and K of std 1e-2")
    for name, fn, idx, flops in (
            (F16_BWD[0], lambda: (flash_attention_bwd_dq_cuda(
                q, k, v, do, lse, delta, causal=True),), (0,), 6),
            (F16_BWD[1], lambda: flash_attention_bwd_dkv_cuda(
                q, k, v, do, lse, delta, causal=True), (1, 2), 8)):
        got = fn()
        torch.cuda.synchronize()
        ok, err, tops = True, 0.0, []
        for g, i in zip(got, idx):
            w = want[i].float()
            fin = torch.isfinite(w)
            ok = ok and bool(torch.isfinite(g[fin]).all().item())
            top = float(w[fin].abs().max())
            e = float((g.float() - w)[fin].abs().max())
            ok = ok and e <= 2e-3 * top
            err, tops = max(err, e), tops + [top]
        # q, k, v, dO read and the outputs written once, lse and delta
        bms, by = bound((4 + len(idx)) * b * s * h * d * 2 + 8 * b * h * s,
                        flops * d * h * pairs, BF16_FLOPS)
        record(name, shape, err, f"finite where the plain version is, 2e-3 "
               f"of the largest output ({tops})", ok, [fn], plain_ms, None,
               bms, by, False, extra={"head_dim": d, "max_abs_dS": max_ds,
                                      "max_abs_out": tops})
    check(max_ds > 65504,
          f"the D {d} range row's |dS| reached only {max_ds}")


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
                           budget_ms=PLAIN_BUDGET_MS)
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
                        tols, wide=False, f16=False, f32=None):
    """Phase 2's rows of the contiguous cache through its identity view
    (``ops.attention.identity_view``, the chunked engine's prompt chunk):
    K2-paged and K2-paged-int8 over an 8-row, 4096-position bf16 cache
    (int8: 128-token scale granules), one 256-query chunk into row 5 at
    pos 0, 1024 and 3840 (``cached_decode_attention(rows=)``, the
    engine's call); then the crossover with K1 over every row of a batch
    at the decode tick's depths, s = 4, 16, 64, 256, both kernels beside
    each other (``crossover`` line): the port's
    ``CONTIGUOUS_Q_TILED_MIN`` is read from it.  ``wide``: the same at a
    Gemma-2B-wide Llama's attention (head_dim 256, 8 query heads over 1
    KV head) over a 2048-position cache (chunks at pos 0, 1024 and 1792),
    every row under the ``/bf16_d256`` entries (``crossover_d256``
    line).  ``f16``: the chunk rows at float16 at Llama-2-7B's attention
    (head_dim 128, 32 over 32 heads) over a 2048-position cache, chunks at
    pos 0 and 1024, under the ``/f16`` entries; no crossover.  ``f32``
    (a head dim): the chunk rows at float32 at that head dim (TinyLlama's
    32 over 4 heads up to 128, a Gemma-2B-wide Llama's 8 over 1 above) over
    a 2048-position cache, chunks at pos 0 and 1024, under the ``/f32``
    entries; no crossover."""
    from paddle_tpu_torch.ops import (cached_decode_attention,
                                      decode_attention_cuda,
                                      decode_attention_int8_cuda)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.ops.attention import CONTIGUOUS_Q_TILED_MIN
    import torch.nn.functional as TF

    dev = torch.device("cuda")
    bf16 = torch.float16 if f16 else torch.bfloat16   # the rows' dtype
    nrow, L, hq, hkv, d, gr = 8, 4096, 32, 8, 128, 128
    chunk_pos = (0, 1024, 3840)
    pos_list = [0, 3000, 17, 1000, 2047, 3000, 511, 128]
    tag = "/identity"
    if wide:
        L, hq, hkv, d = F32_L, G2B_HEADS, G2B_KV_HEADS, 256
        chunk_pos = (0, 1024, 1792)
        pos_list = [min(p, L - 256) for p in pos_list]
        tag = BF16_D256
    if f16:
        L, hq, hkv = F32_L, L27_HEADS, L27_HEADS
        chunk_pos = (0, 1024)
        tag = F16
    # the rows' bytes an element and peak rates (over float or int8 K / V)
    esz, peak, peak8 = 2, BF16_FLOPS, BF16_FLOPS
    if f32:
        bf16, d, L, chunk_pos, tag = torch.float32, f32, F32_L, (0, 1024), F32
        hq, hkv = ((TL_HEADS, TL_KV_HEADS) if d <= 128
                   else (G2B_HEADS, G2B_KV_HEADS))
        esz, peak, peak8 = 4, F32_TC_FLOPS, F32_I8_TC_FLOPS
    atol, rtol = tols(bf16)

    def cache_sets(int8, n):
        if int8:
            return [(int8_payload(nrow, L, hkv, d),
                     int8_payload(nrow, L, hkv, d),
                     int8_scales(nrow, L // gr, hkv),
                     int8_scales(nrow, L // gr, hkv)) for _ in range(n)]
        return [(randn(nrow, L, hkv, d, dtype=bf16),
                 randn(nrow, L, hkv, d, dtype=bf16)) for _ in range(n)]

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
        nbytes = 2 * b * s * hq * d * esz + live * hkv * d * (
            1 if int8 else esz) * 2
        if int8:
            nbytes += sum(-(-min(L, p + s) // gr) for p in pos_list) \
                * hkv * 4 * 2
        ops = sum(4 * d * hq * min(p + si + 1, L)
                  for p in pos_list for si in range(s))
        return bound(nbytes, ops, peak8 if int8 else peak)

    for int8 in (False, True):
        name = ("flash_attention_fwd_paged_int8" if int8
                else "flash_attention_fwd_paged") + tag
        note = INT8_LIBRARY_NOTE if int8 else (
            "F.scaled_dot_product_attention over the row's keys [0, pos + "
            "s), copied out beforehand (not timed)")
        s = 256
        for p in chunk_pos:
            sets = cache_sets(int8, copies((p + s) * hkv * d * 2 * 2))
            q = randn(1, s, hq, d, dtype=bf16)
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            rows = torch.tensor([5], dtype=torch.int32, device=dev)

            def run(c):
                kw = dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
                return cached_decode_attention(q, c[0], c[1], pos,
                                               rows=rows, **kw)
            got = run(sets[0])
            with reference_mode():
                want = run(sets[0])
            extra, tol = {"head_dim": d}, f"atol {atol} + rtol {rtol}"
            if f32:
                # the yardstick: the plain version in float64
                with reference_mode():
                    truth = cached_decode_attention(
                        q.double(), *as_f64(sets[0])[:2], pos, rows=rows,
                        **(dict(zip(("k_scale", "v_scale"),
                                    as_f64(sets[0][2:]))) if int8 else {}))
                want, tol, vs = vs_f64(got, want, truth, tol)
                extra.update(vs, deterministic=bool(torch.equal(
                    got, run(sets[0]))))
            torch.cuda.synchronize()
            err = max_err(got, want)
            ok = within(got, want, atol, rtol) and bool(
                torch.isfinite(got).all().item()) and extra.get(
                    "deterministic", True)
            kfns = [lambda c=c: run(c) for c in sets]
            with reference_mode():
                plain_ms = time_ms(torch, kfns, budget_ms=PLAIN_BUDGET_MS)
            lib_ms = time_ms(torch, [library(q, c, [5], [p], s)
                                     for c in sets[:2]])
            bms, by = traffic(int8, s, [p], 1)
            record(name,
                   f"identity view: cache B={nrow} L={L} Hq={hq} Hkv={hkv} "
                   f"D={d} block_len={gr if int8 else 64}, row 5, s={s} "
                   f"pos={p}" + (f" int8 K/V granule {gr}, {str(bf16)[6:]} q"
                                 if int8 else f" {str(bf16)[6:]}"),
                   err, tol, ok, kfns, plain_ms,
                   lib_ms, bms, by, p == 1024 and not (wide or f16 or f32),
                   note=note, extra=extra)
            del sets, got, want
    if f16 or f32:
        return

    # the crossover: K1 (8-row tiles, each re-reading its row's live
    # prefix) against K2-paged over the identity view, one batch
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
                    for c in sets[:2]], budget_ms=PLAIN_BUDGET_MS)
            shape = (f"B={nrow} s={s} L={L} Hq={hq} Hkv={hkv} D={d} "
                     f"pos={pos_list}" + (f" int8 K/V granule {gr}"
                                          if int8 else " bfloat16"))
            row = {"s": s, "int8": int8}
            for kname, got, fns in (
                    ("decode_attention" + ("_int8" if int8 else "")
                     + (BF16_D256 if wide else ""), got1,
                     [lambda c=c: k1(q, c[0], c[1], pos=pos, **kw(c))
                      for c in sets]),
                    (("flash_attention_fwd_paged_int8" if int8 else
                      "flash_attention_fwd_paged") + tag, got2,
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
    emit({"phase": "crossover_d256" if wide else "crossover",
          "threshold": CONTIGUOUS_Q_TILED_MIN, "head_dim": d, "rows": cross})


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
    run["eager_twin"] = twin
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


# the engine's latency series (metrics() key -> its registry histogram)
# and counters that a pass of a reused engine reads as its own share
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
    """One 8B-width serving run (8 slots, max_length 4096, prefill_batch 4
    unless ``kw`` says otherwise): the observability layer is reset (the
    registry, span tracer and request log hold this engine's run alone:
    no family nears FLAGS_metrics_max_children), the engine is built (its
    decode step's warm-up and graph capture included, unless
    ``disable_graphs()`` is open), then every launch and route counter is
    reset just before the requests are submitted and read just after the
    drain.  Returns the run
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
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.serving import ServingEngine

    observability.reset()
    eng = ServingEngine(model, device="cuda", **{
        "num_slots": 8, "max_length": 4096, "prefill_batch": 4, **kw})
    keys = record_wave_keys(eng)
    run = _serve_pass(torch, eng, prompts, new_tokens, keys, submit_kw)
    if warm:
        run["warm"] = _serve_pass(torch, eng, prompts, new_tokens, keys,
                                  warm_kw(run) if warm_kw else submit_kw)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return run


def record_wave_keys(eng):
    """A list that each wave ``eng`` runs from now on appends its (bucket,
    rows) key to."""
    keys = []
    for name in ("_prefill", "_prefill_paged"):
        def record(ids, *args, _fn=getattr(eng, name), **kwargs):
            keys.append((int(ids.shape[1]), int(ids.shape[0])))
            return _fn(ids, *args, **kwargs)
        setattr(eng, name, record)
    return keys


def timed_step(eng, step, ticks):
    """``step()``, appending its host-clock milliseconds to ``ticks`` when
    it ran one decode tick of ``eng`` and no wave (a tick ends in its one
    host fetch, so its device work is inside)."""
    t, d = eng._ticks, eng._n_decode_ticks
    t0 = time.perf_counter()
    out = step()
    ms = (time.perf_counter() - t0) * 1e3
    if eng._ticks == t + 1 and eng._n_decode_ticks == d + 1:
        ticks.append(ms)
    return out


def record_tick_ms(eng):
    """A list that each ``eng.step()`` from now on that runs one decode
    tick and no wave appends its milliseconds to (:func:`timed_step`)."""
    ticks = []
    step = eng.step
    eng.step = lambda: timed_step(eng, step, ticks)
    return ticks


def _serve_pass(torch, eng, prompts, new_tokens, keys, submit_kw=None):
    """One pass of ``prompts`` through ``eng`` (see :func:`_serve_8b`):
    counters, latency series and wave keys of this pass alone; a draft
    model's builds and step runs under ``draft``; the observability
    layer's record of the engine so far under ``obs``
    (:func:`obs_capture`)."""
    from paddle_tpu_torch import observability, ops
    from paddle_tpu_torch.ops import _dispatch

    before = eng.metrics()
    marks = {k: hist_mark(getattr(eng, h)) for k, h in PASS_HISTS.items()}
    spec_marks = spec_hist_marks(eng)
    uid0 = observability.get_request_log().mark()
    k0 = len(keys)
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    submit_kw = submit_kw or [{}] * len(prompts)
    rids = [eng.submit(p, max_new_tokens=new_tokens, **skw)
            for p, skw in zip(prompts, submit_kw)]
    out, tick_ms = drain_timed(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics()
    m["decode_tick_ms"] = exact_summary(tick_ms)
    for k in PASS_COUNTS:
        if k in m:
            m[k] -= before[k]
    for k, h in PASS_HISTS.items():
        if k in m:
            m[k] = hist_pass(getattr(eng, h), marks[k])
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
           "cache_bytes": eng.cache_hbm_bytes,
           "obs": obs_capture(eng, uid0)}
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


def drain_timed(eng):
    """``eng.drain()``, timing each ``step()`` that ran one decode tick and
    no wave (:func:`timed_step`).  Returns (request id -> tokens, those
    ms)."""
    ticks = []
    while (eng._queue or eng._resume_q or eng._swap_resume
           or eng._cursor is not None
           or any(s is not None for s in eng._slots)):
        timed_step(eng, eng.step, ticks)
    return dict(eng.drain()), ticks


def exact_summary(values):
    """count, mean, p50 / p90 / p99 of ``values`` (ms), exactly: the
    registry's histograms interpolate inside buckets (5-10 ms for an 8B
    tick), too coarse to compare two runs by a few percent."""
    import numpy as np
    d = {"count": len(values)}
    if values:
        a = np.asarray(values)
        d["mean"] = round(float(a.mean()), 3)
        for q in (50, 90, 99):
            d[f"p{q}"] = round(float(np.percentile(a, q)), 3)
    return d


def hist_mark(h):
    """Where registry histogram child ``h`` stands: (its bucket counts,
    sum, count), so a pass reads its own share (:func:`hist_pass`)."""
    with h._lock:
        return list(h._counts), h._sum, h._count


def hist_pass(h, mark):
    """The engine's ``metrics()`` readout (count, p50 / p90 / p99 from the
    buckets) of what ``h`` observed since ``mark``."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving.engine import hist_summary
    part = MetricsRegistry().histogram(
        "pass", buckets=h._family.buckets).labels()
    counts, total, n = hist_mark(h)
    part._counts = [a - b for a, b in zip(counts, mark[0])]
    part._sum, part._count = total - mark[1], n - mark[2]
    return hist_summary(part)


def spec_hist_marks(eng):
    """Where each accepted-per-step series of a speculative engine stands
    (engine total and by drafter kind), so a pass reads its own share."""
    if not getattr(eng, "spec", False):
        return {}
    marks = {None: hist_mark(eng._m_spec_accept)}
    marks.update({k: hist_mark(c[4])
                  for k, c in eng._spec_children.items()})
    return marks


def spec_pass(now, before, eng, marks):
    """A pass's share of the engine's ``metrics()["spec"]`` block: the
    counts less ``before``'s, the accepted-per-step series from
    ``marks`` on (:func:`spec_hist_marks`)."""
    def share(cur, old, h, mark):
        out = dict(cur)
        for k in SPEC_COUNTS:
            out[k] = cur[k] - (old or {}).get(k, 0)
        out["draft_hit_rate"] = (round(out["draft_hit_tokens"]
                                       / out["drafted_tokens"], 3)
                                 if out["drafted_tokens"] else 0.0)
        acc = hist_pass(h, mark)
        if acc["count"]:
            acc["mean"] = round((h.sum - mark[1]) / acc["count"], 3)
        out["accepted_per_step"] = acc
        return out
    zero = ([0] * (len(eng._m_spec_accept._counts)), 0.0, 0)
    out = share(now, before, eng._m_spec_accept, marks[None])
    if "by_drafter" in now:
        out["by_drafter"] = {
            k: share(v, before.get("by_drafter", {}).get(k),
                     eng._spec_children[k][4], marks.get(k, zero))
            for k, v in now["by_drafter"].items()}
    return out


def serving_fields(run):
    """The timing and graph fields of a serving run's JSON line."""
    m = run["metrics"]
    ntok = sum(len(o) for o in run["outs"])
    out = {"tokens": ntok, "wall_s": round(run["wall"], 4),
           "tok_per_s": round(ntok / run["wall"], 2),
           "decode_step_ms": m["decode_step_ms"],
           "decode_tick_ms": m["decode_tick_ms"], "ttft_ms": m["ttft_ms"],
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


def eager_twin(torch, model, prompts, run, what, submit_kw=None,
               new_tokens=32, **kw):
    """The same engine on the same requests with its decode step run
    eagerly (``disable_graphs()``, the port's ``jax.disable_jit()``).
    Returns the twin's line: its timings, its graph fields, the token
    comparison with the graphed ``run`` and whether its launch and route
    counts equal the graphed run's (the replay accounting credits what
    the eager ticks launch, no more and no less)."""
    from paddle_tpu_torch.serving import disable_graphs

    with disable_graphs():
        twin = _serve_8b(torch, model, prompts, new_tokens=new_tokens,
                         submit_kw=submit_kw, **kw)
    check_graph(twin, f"{what} eager twin", graphed=False)
    out = {**serving_fields(twin),
           **twin_comparison(run["outs"], twin["outs"]),
           "launches_identical": twin["launches"] == run["launches"],
           "routes_identical": twin["routes"] == run["routes"],
           "timelines_identical": (twin["obs"]["signature"]
                                   == run["obs"]["signature"])}
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
                "tick_ms_p50": m.get("decode_tick_ms", {}).get("p50"),
                "mixed_step_ms_p50": m.get("mixed_step_ms", {}).get("p50"),
                "peak_memory_gb": r["peak_memory_gb"]}
    same = sum(a == b for a, b in zip(run["outs"], base["outs"]))
    sp = run["metrics"]["spec"]
    return {"spec": sp, "accepted_per_step_mean":
            sp["accepted_per_step"].get("mean"),
            "this_run": one(run), "non_spec_phase": one(base),
            "same_tokens_as_non_spec": f"{same}/{len(run['outs'])}"}


def attention_launches(m, attention, layers=LAYERS_8B):
    """The launches each kernel of ``attention`` owes a run with metrics
    ``m``: ``layers`` a unit (name -> units: "tick" every decode or verify
    tick, "wave" every prefill wave, "mixed" every chunk, "ticks" every
    tick of a chunked engine)."""
    per = {"tick": m["decode_ticks"], "wave": m["prefill_waves"],
           "mixed": m.get("mixed_ticks", 0), "ticks": m["ticks"]}
    return {name: layers * sum(per[u] for u in units)
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


# -- phases 4l / 4m: the paged cache's memory tiers ------------------------------

# phase 4m: four requests of these lengths, 32 new tokens each, over 128-token
# blocks need 9, 8, 9 and 7 blocks; the pool holds 26, room for three
PREEMPT_PROMPT_LENGTHS = (1000, 900, 1100, 800)
PREEMPT_POOL_BLOCKS = 27
PREEMPT_HOST_BLOCKS = 20      # two victims' private blocks
PREEMPT_MAX_LENGTH = 2048
PREEMPT_CHUNK = 256           # the cancel engines' prefill_chunk
MIXED_NEW_TOKENS = 32         # phase 4l's new tokens a request
MIXED_MAX_LENGTH = 4096       # phase 4l's slots (phase 4b's)
MIXED_MIN_DEMOTED = 12        # phase 4l: the system prompt's full blocks
HOST_TIER_NEW_TOKENS = 64     # the host tier's run: new tokens a request


def demote_round_trip(torch, blk):
    """A block (L, 2, block_len, Hkv, D) through the mixed pool's int8
    round trip, on the CPU in float32 from the block's values: per (layer,
    K / V, kv head) the scale absmax x float32(1 / 127), the block divided
    by it, rounded half to even, clipped to +-127, multiplied back; in the
    block's dtype.  The reference is ``_demote_impl``
    (``paddle_tpu/serving/engine.py:587-598``)."""
    x = blk.float().cpu()
    sc = x.abs().amax(dim=(2, 4), keepdim=True) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32)
    safe = torch.where(sc > 0, sc, torch.ones_like(sc))
    q = torch.clamp(torch.round(x / safe), -127, 127)
    return (q * safe).to(blk.dtype)


def bits_equal(torch, a, b) -> bool:
    """Bitwise equality of two tensors of one dtype, on the CPU."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    it = ints[a.element_size()]
    return bool(torch.equal(a.view(it), b.view(it)))


@contextlib.contextmanager
def spy_first_demotion(seen):
    """While open, the first block any mixed engine demotes is copied
    (to the CPU) just before and just after its rewrite, into ``seen``."""
    from paddle_tpu_torch.serving import engine as engine_mod

    orig = engine_mod._DemoteOp.__call__

    def spy(op, bid):
        if "after" in seen:
            return orig(op, bid)
        seen["bid"] = int(bid)
        seen["before"] = op._pool[:, :, bid].to("cpu", copy=True)
        orig(op, bid)
        seen["after"] = op._pool[:, :, bid].to("cpu", copy=True)
    engine_mod._DemoteOp.__call__ = spy
    try:
        yield seen
    finally:
        engine_mod._DemoteOp.__call__ = orig


def phase_serving_mixed(torch, model, kernels, paged_run):
    """Phase 4l: the mixed bf16/int8 pool at the Llama-3-8B width.  Phase
    4b's engine (``block_len`` 128, ``num_blocks`` 52) with
    ``kv_cache_dtype="mixed"`` on phase 4b's eight requests that open with
    the shared 1536-token system prompt, graphed beside its eager twin.
    Gates: tokens, launches and routes equal to the twin's,
    ``step_traces`` 1 and the demote op built once (``serving.demote``);
    ``quantized_blocks`` at least 12 (the system prompt's blocks) and equal
    to the demotions (the pool evicts nothing here), ``bytes_by_dtype
    ["int8"]`` = ``quantized_blocks`` x the int8 block's bytes; the first
    demoted block, copied before and after its rewrite, equal bit for bit
    to its round trip computed on the CPU (:func:`demote_round_trip`);
    K1-paged 32 a decode tick, K2-paged 32 a wave, no other attention
    kernel, no plain route.  Reported, not gated: how many requests'
    tokens equal phase 4b's (the reference's int8 path is not
    token-identical to its bf16 path either)."""
    kw = dict(paged=True, block_len=128, num_blocks=PAGED_POOL_BLOCKS,
              kv_cache_dtype="mixed")
    prompts = paged_serving_prompts(model.config.vocab_size)[0::2]
    new = MIXED_NEW_TOKENS
    kw["max_length"] = MIXED_MAX_LENGTH
    with spy_first_demotion({}) as seen:
        run = _serve_8b(torch, model, prompts, new_tokens=new, **kw)
    what = "phase 4l"
    twin = eager_twin(torch, model, prompts, run, what, new_tokens=new, **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    kv = m["kv_cache"]
    c = model.config
    int8_block = (c.num_hidden_layers * 2 * c.num_key_value_heads
                  * (128 * c.head_dim + 4))
    want = demote_round_trip(torch, seen["before"])
    bf16_outs = paged_run["outs"][0::2]
    emit({"phase": "serving_mixed", "requests": len(prompts),
          "prompt_lengths": [int(p.size) for p in prompts],
          "block_len": 128, "num_blocks": PAGED_POOL_BLOCKS,
          "kv_cache_dtype": "mixed", "new_tokens": new,
          **serving_fields(run), "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"], "kv_cache": kv,
          "int8_block_bytes": int8_block,
          "demoted_block": seen["bid"],
          "demoted_block_bit_exact": bits_equal(torch, seen["after"], want),
          "demoted_block_changed": not bits_equal(torch, seen["after"],
                                                 seen["before"]),
          "same_tokens_as_bf16_phase_4b":
              f"{sum(a[:new] == b[:new] for a, b in zip(run['outs'], bf16_outs))}"
              f"/{len(prompts)}",
          "launches": launches, "routes": routes, "eager_twin": twin})
    check_graph(run, what)
    check_twin(twin, what)
    check(kv["demote_traces"] == 1,
          f"{what}: the demote op was built {kv['demote_traces']} times")
    check(kv["quantized_blocks"] >= MIXED_MIN_DEMOTED
          and kv["quantized_blocks"] == kv["demoted_blocks"],
          f"{what}: quantized_blocks {kv['quantized_blocks']}, demotions "
          f"{kv['demoted_blocks']}")
    check(kv["bytes_by_dtype"]["int8"]
          == kv["quantized_blocks"] * int8_block,
          f"{what}: int8 bytes {kv['bytes_by_dtype']['int8']} for "
          f"{kv['quantized_blocks']} blocks of {int8_block}")
    check(bits_equal(torch, seen["after"], want),
          f"{what}: demoted block {seen['bid']} differs from its round "
          f"trip on the CPU")
    check(kv["blocks_in_use"] == 0, f"{what}: blocks in use after the drain")
    check_attention_launches(what, launches, routes, attention_launches(
        m, {"decode_attention_paged": ("tick",),
            "flash_attention_fwd_paged": ("wave",)}))
    return run


def preempt_prompts(vocab: int):
    import numpy as np
    rng = np.random.RandomState(5)
    return [rng.randint(0, vocab, n).astype(np.int32)
            for n in PREEMPT_PROMPT_LENGTHS]


def _preempt_engine(model, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, device="cuda", **{
        "num_slots": 4, "max_length": PREEMPT_MAX_LENGTH,
        "prefill_batch": 2, "paged": True, "block_len": 128,
        "num_blocks": PREEMPT_POOL_BLOCKS, **kw})


def saturate(eng, prompts, new_tokens=32, steps=3, ticks=None):
    """``tests/test_serving_preempt.py::_saturate``: two priority-0
    requests decode first, then two priority-5 arrivals find the pool
    full.  Returns the outputs in submit order; ``ticks``, a list, gets
    the drain's decode tick ms (:func:`drain_timed`)."""
    rids = [eng.submit(p, max_new_tokens=new_tokens, priority=0)
            for p in prompts[:2]]
    for _ in range(steps):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=new_tokens, priority=5)
             for p in prompts[2:]]
    out, tick_ms = drain_timed(eng)
    if ticks is not None:
        ticks.extend(tick_ms)
    return [out[r] for r in rids]


def preempt_run(torch, model, prompts, graphed=True, swap_check=None, **kw):
    """One :func:`saturate` run on a fresh engine (graphed, or built inside
    ``disable_graphs()``), its launch and route counters reset just before
    and read just after.  ``swap_check``: a dict the swap hooks fill,
    every swapped-out payload held and each block read back after its
    swap-in compared with it bit for bit."""
    from paddle_tpu_torch import observability, ops
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.serving import disable_graphs

    observability.reset()
    with (contextlib.nullcontext() if graphed else disable_graphs()):
        eng = _preempt_engine(model, **kw)
    if swap_check is not None:
        swap_check.update(held={}, blocks=0, equal=0)
        out_hook, in_hook = eng.kv.on_swap_out, eng.kv.on_swap_in

        def on_out(pairs):
            out_hook(pairs)
            for _, hid in pairs:
                swap_check["held"][hid] = tuple(
                    t.clone() for t in eng.kv.host_tier.get(hid))

        def on_in(pairs):
            in_hook(pairs)
            for hid, bid in pairs:
                back = eng._read_block(bid)
                swap_check["blocks"] += 1
                swap_check["equal"] += all(
                    bits_equal(torch, a, b) for a, b in
                    zip(back, swap_check["held"].pop(hid)))
        eng.kv.on_swap_out, eng.kv.on_swap_in = on_out, on_in
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    uid0 = observability.get_request_log().mark()
    t0 = time.perf_counter()
    ticks = []
    outs = saturate(eng, prompts, ticks=ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {"outs": outs, "wall": wall, "launches": ops.launch_counts(),
           "routes": {f"{op}/{path}": n for (op, path), n in
                      _dispatch.kernel_paths.items()},
           "metrics": dict(eng.metrics(),
                           decode_tick_ms=exact_summary(ticks)),
           "graphed": eng.graphed,
           "decisions": eng.preempt_decisions,
           "signature": eng.preempt_signature(), "engine": eng,
           "obs": obs_capture(eng, uid0)}
    return run


def block_move_ms(torch, eng, bid, reps=5):
    """Median ms of one block's swap-out (:meth:`ServingEngine._read_block`:
    into pinned host memory, complete on return) and swap-in
    (:meth:`ServingEngine._write_block` and a synchronisation), of block
    ``bid`` of ``eng``'s pool (its content written back unchanged)."""
    outs, ins = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = eng._read_block(bid)
        outs.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        eng._write_block(bid, payload)
        torch.cuda.synchronize()
        ins.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(t.numel() * t.element_size() for t in payload)
    return {"block_bytes": nbytes,
            "swap_out_ms": round(sorted(outs)[reps // 2], 4),
            "swap_in_ms": round(sorted(ins)[reps // 2], 4),
            "pinned": bool(payload[0].is_pinned())}


def preempt_fields(run):
    m = run["metrics"]
    ntok = sum(len(o) for o in run["outs"])
    out = {"tokens": ntok, "wall_s": round(run["wall"], 4),
           "tok_per_s": round(ntok / run["wall"], 2),
           "ttft_ms": m["ttft_ms"], "tpot_ms": m["tpot_ms"],
           "decode_step_ms": m["decode_step_ms"],
           "decode_tick_ms": m["decode_tick_ms"],
           "prefill_wave_ms": m["prefill_wave_ms"],
           "graphed": run["graphed"], "step_traces": m["step_traces"],
           "graph_replays": m["graph_replays"],
           "prefill_waves": m["prefill_waves"],
           "decode_ticks": m["decode_ticks"], "preempt": m["preempt"],
           "decisions": run["decisions"]}
    if "host_tier" in m["kv_cache"]:
        out["host_tier"] = m["kv_cache"]["host_tier"]
    return out


def phase_serving_preempt(torch, model):
    """Phase 4m: preemption, the host tier, cancel and migration at the
    Llama-3-8B width (bf16, 32 layers), block_len 128.  A 26-block pool
    holds three of four requests (``PREEMPT_PROMPT_LENGTHS``, 32 new
    tokens): two priority-0 requests decode, then two priority-5 arrivals
    (:func:`saturate`).  In ``swap`` (a 20-block host tier) and
    ``recompute`` mode, each graphed and as its eager twin.  Gates: at
    least one preemption in each mode, the decisions' signature equal in
    the graphed and the eager run, ``step_traces`` 1, one replay a tick
    and a wave (the twin none), K1-paged 32 a decode tick and K2-paged 32
    a wave (a recompute resume's re-prefill is a wave), no plain route,
    no block in use after the drain; swap: tokens equal to the
    ``preempt="off"`` run of the same submissions and every swapped block
    read back after its swap-in equal to its swapped-out bytes, in both
    runs; recompute: tokens equal to the twin's (its re-prefill takes
    K2-paged where the first pass took K1-paged, so the count equal to
    the off-run's is reported, not gated).  Then ``cancel`` in five states
    (:func:`cancel_states`), the host tier's demotion and promotion
    (:func:`host_tier_run`), a migration between two engines
    (:func:`migration_run`) and the float32 tiny engines card against CPU
    (:func:`tiny_tiers_card_vs_cpu`).  Reported: swap bytes, the host
    tier's pinned bytes, one block's swap-out / swap-in ms, TTFT / TPOT of
    the preempting runs."""
    prompts = preempt_prompts(model.config.vocab_size)
    off = preempt_run(torch, model, prompts, preempt="off")
    off_outs = off["outs"]
    del off["engine"]
    for mode, extra in (("swap", {"host_blocks": PREEMPT_HOST_BLOCKS}),
                        ("recompute", {})):
        what = f"phase 4m ({mode})"
        checks = [{}, {}] if mode == "swap" else [None, None]
        run = preempt_run(torch, model, prompts, preempt=mode,
                          swap_check=checks[0], **extra)
        eng = run.pop("engine")
        twin = preempt_run(torch, model, prompts, graphed=False,
                           preempt=mode, swap_check=checks[1], **extra)
        del twin["engine"]
        m, launches, routes = run["metrics"], run["launches"], run["routes"]
        line = {"phase": "serving_preempt", "mode": mode,
                "prompt_lengths": list(PREEMPT_PROMPT_LENGTHS),
                "new_tokens": 32, "num_blocks": PREEMPT_POOL_BLOCKS,
                "block_len": 128, **preempt_fields(run),
                "same_tokens_as_off_run":
                    f"{sum(a == b for a, b in zip(run['outs'], off_outs))}"
                    f"/{len(prompts)}",
                "launches": launches, "routes": routes,
                "eager_twin": {**preempt_fields(twin), **twin_comparison(
                    run["outs"], twin["outs"]),
                    "launches_identical": twin["launches"] == launches,
                    "routes_identical": twin["routes"] == routes}}
        if mode == "swap":
            line["swapped_blocks_checked"] = [c["blocks"] for c in checks]
            line["block_move"] = block_move_ms(torch, eng, 1)
            line["host_cache_bytes"] = eng.host_cache_bytes
        del eng
        emit(line)
        check(sum(m["preempt"]["preemptions"].values()) >= 1,
              f"{what}: no preemption")
        check(run["signature"] == twin["signature"],
              f"{what}: the decisions differ from the eager run's: "
              f"{run['decisions']} vs {twin['decisions']}")
        check_graph(run, what)
        check_graph(twin, f"{what} eager twin", graphed=False)
        check_twin(line["eager_twin"], what)
        check(m["kv_cache"]["blocks_in_use"] == 0 and m["preempt"][
            "awaiting_resume"] == 0, f"{what}: blocks in use after the drain")
        check_attention_launches(what, launches, routes, attention_launches(
            m, {"decode_attention_paged": ("tick",),
                "flash_attention_fwd_paged": ("wave",)}))
        if mode == "swap":
            check(run["outs"] == off_outs,
                  f"{what}: tokens differ from the preempt='off' run")
            for c in checks:
                check(c["blocks"] > 0 and c["equal"] == c["blocks"],
                      f"{what}: {c['blocks'] - c['equal']} of "
                      f"{c['blocks']} swapped blocks read back differ")
            swap = run
    cancel_states(torch, model, prompts)
    host_tier_run(torch, model)
    migration_run(torch, model, prompts)
    tiny_tiers_card_vs_cpu(torch)
    return swap


# -- phase 4n: the observability layer of phases 4b, 4c and 4m ------------------

# metrics() key -> the registry family behind it (the engine=<id> series)
METRICS_COUNTERS = {
    "requests_submitted": "serving.requests_submitted",
    "requests_finished": "serving.requests_finished",
    "tokens_generated": "serving.tokens_generated",
    "prefill_waves": "serving.prefill_waves",
    "prefill_tokens_computed": "serving.prefill_tokens_computed",
    "prefill_tokens_total": "serving.prefill_tokens_total",
    "cancelled": "serving.cancelled"}
METRICS_HISTS = {"ttft_ms": "serving.ttft_ms", "tpot_ms": "serving.tpot_ms",
                 "queue_wait_ms": "serving.queue_wait_ms",
                 "decode_step_ms": "serving.decode_step_ms",
                 "prefill_wave_ms": "serving.prefill_wave_ms"}
METRICS_BY_LABEL = {"slo_violations": ("serving.slo_violations", "kind"),
                    "retired": ("serving.retired", "reason")}
# metrics()["kv_cache"] keys read from kv_cache.<key>{pool=<id>}
KV_SERIES = ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens",
             "evictions", "cow_copies", "peak_blocks_in_use",
             "blocks_in_use")
# the lifecycle a request of phase 4b walks, and a swapped-out victim of
# phase 4m's swap run (first occurrences, in this order)
LIFECYCLE_4B = ("admitted", "prefill", "first_token", "retired")
LIFECYCLE_SWAP = ("preempted", "swapped_out", "swapped_in", "resumed",
                  "retired")
# the kernel routes phases 4b and 4c must show in the registry
OBS_ROUTES = {"4b": ("decode_attention_paged", "paged_prefill", "rms_norm"),
              "4c": ("decode_attention_paged_int8", "paged_prefill_int8",
                     "rms_norm", "int8_matmul")}


def obs_capture(eng, uid0):
    """The observability layer's record of ``eng`` once a pass drained,
    kept for phase 4n (the engine is freed): the request log's timelines
    of the requests submitted since ``uid0`` (event names by uid, and
    their ``timeline_signature``), ``observability.snapshot()``, the
    engine's whole ``metrics()`` (as the registry holds it) and
    ``perf_report()``, its id, pool id, device and rid -> uid map, and the
    span tracer's Chrome trace parsed back from its JSON text (complete
    spans counted by name)."""
    from paddle_tpu_torch import observability
    log = observability.get_request_log()
    uid1 = log.mark()
    trace = json.loads(json.dumps(observability.export_chrome_trace()))
    spans = collections.Counter(e["name"] for e in trace["traceEvents"]
                                if e.get("ph") == "X")
    return {"engine": eng._eid,
            "pool": eng.kv._pid if eng.paged else None,
            "device": eng.device.type,
            "uids": dict(eng._uids),
            "events": {uid: [ev["name"] for ev in rec]
                       for uid, rec in log.records(uid0, uid1).items()},
            "signature": log.timeline_signature(uid0, uid1),
            "snapshot": observability.snapshot(),
            "metrics": eng.metrics(),
            "perf": eng.perf_report(),
            "spans": dict(spans),
            "trace_dropped": trace["otherData"]["dropped_events"]}


def registry_rows(snap, family, **labels):
    """The rows of ``family`` in snapshot ``snap`` whose labels include
    ``labels``."""
    return [r for r in snap.get(family, {}).get("series", [])
            if all(r["labels"].get(k) == v for k, v in labels.items())]


def metrics_vs_registry(m, snap, eid, pool=None):
    """The keys of engine metrics ``m`` that differ from the registry's
    series in ``snap`` for ``engine=eid`` (and ``pool=pool``): counters
    exactly, histograms' counts exactly and percentiles within the
    readouts' rounding, the labelled families as dicts."""
    bad = []

    def one(family, **labels):
        rows = [r for r in registry_rows(snap, family, **labels)
                if set(r["labels"]) == set(labels)]
        return rows[0] if len(rows) == 1 else None

    for k, fam in METRICS_COUNTERS.items():
        r = one(fam, engine=eid)
        if r is None or int(r["value"]) != m[k]:
            bad.append(k)
    for k, fam in METRICS_HISTS.items():
        r = one(fam, engine=eid)
        if r is None or r["count"] != m[k]["count"] or any(
                abs(r[q] - m[k][q]) > 1.001e-3
                for q in ("p50", "p90", "p99") if q in m[k]):
            bad.append(k)
    for k, (fam, lab) in METRICS_BY_LABEL.items():
        got = {r["labels"][lab]: int(r["value"])
               for r in registry_rows(snap, fam, engine=eid)}
        if got != m[k]:
            bad.append(k)
    if pool is not None:
        kv = m["kv_cache"]
        for k in KV_SERIES:
            r = one(f"kv_cache.{k}", pool=pool)
            if r is None or int(r["value"]) != kv[k]:
                bad.append(f"kv_cache.{k}")
        r = one("serving.admission_blocked", engine=eid)
        if r is None or int(r["value"]) != kv["admission_blocked"]:
            bad.append("kv_cache.admission_blocked")
    return bad


def in_order(names, order) -> bool:
    """Every event of ``order`` occurs in ``names``, first occurrences in
    that order."""
    idx = [names.index(n) if n in names else -1 for n in order]
    return min(idx) >= 0 and idx == sorted(idx)


def perf_fields(obs, ticks, what):
    """The cost model's line for one run, and its gates: enabled, on the
    ``h100`` profile on the card (``cpu_smoke`` on the CPU), the bounds'
    ticks and shares partitioning the ``ticks`` modelled (every decode
    tick)."""
    rep = obs["perf"]
    want = "h100" if obs["device"] == "cuda" else "cpu_smoke"
    check(rep.get("enabled") and rep["profile"]["name"] == want,
          f"{what}: perf_report() not enabled on the {want} profile: "
          f"{rep.get('profile')}")
    bounds = rep.get("bounds", {})
    check(rep.get("ticks_modeled") == ticks
          and sum(b["ticks"] for b in bounds.values()) == ticks
          and abs(sum(b["share"] for b in bounds.values()) - 1.0) < 1e-5,
          f"{what}: the bounds {bounds} do not partition the "
          f"{ticks} ticks ({rep.get('ticks_modeled')} modelled)")
    return {"profile": rep["profile"]["name"],
            "ticks_modeled": rep.get("ticks_modeled"), "bounds": bounds,
            "predicted_ms": rep.get("predicted_ms"),
            "measured_ms_sum": rep.get("measured_ms_sum"),
            "measured_over_predicted": rep.get("ratio"),
            "model_inputs": rep.get("model_inputs"),
            "drift": rep.get("drift"), "anomalies": rep.get("anomalies")}


def phase_observability(paged, int8, swap):
    """Phase 4n: what the observability layer recorded of phases 4b (bf16
    paged), 4c (int8) and 4m's swap run (:func:`obs_capture`); builds no
    engine.  Gates: the registry's ``ops.kernel_path`` shows the kernel
    route of K1-paged, K2-paged and RMSNorm (4c: their int8 builds and
    K4) and no plain route; each 4b request's events in the order
    ``admitted`` < ``prefill`` < ``first_token`` < ``retired``, and the
    graphed engine's ``timeline_signature`` equal to its eager twin's;
    each swap victim's ``preempted`` < ``swapped_out`` < ``swapped_in`` <
    ``resumed`` < ``retired``, and the registry's
    ``kv_cache.swapped_out_blocks`` equal to the engine's count and to
    the blocks swapped back in; ``metrics()`` equal to the registry's
    series of its engine (and pool); ``perf_report()`` enabled on the
    ``h100`` profile with the bounds partitioning the decode ticks, and a
    swap term > 0 in the swap run; the 4b Chrome trace parses back from
    JSON with one ``serving.decode`` span a decode tick and nothing
    dropped.  Reported, not gated: the measured / predicted tick ratio
    (p50 / p90) and any drift finding."""
    t0 = time.perf_counter()
    line = {"phase": "observability"}
    for what, run in (("4b", paged), ("4c", int8)):
        snap = run["obs"]["snapshot"]
        routes = {f"{r['labels']['op']}/{r['labels']['path']}":
                  int(r["value"])
                  for r in registry_rows(snap, "ops.kernel_path")}
        line[f"routes_{what}"] = routes
        for op in OBS_ROUTES[what]:
            check(routes.get(f"{op}/kernel", 0) > 0,
                  f"phase 4n ({what}): no kernel route for {op} in the "
                  f"registry (a plain route ran)")
        plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
        check(not plain, f"phase 4n ({what}): plain routes in the "
                         f"registry: {plain}")
    obs = paged["obs"]
    bad = [uid for uid, names in obs["events"].items()
           if not in_order(names, LIFECYCLE_4B)]
    line["lifecycle_4b"] = {"requests": len(obs["events"]),
                            "out_of_order": bad,
                            "twin_identical":
                                paged["eager_twin"]["timelines_identical"]}
    check(len(obs["events"]) == len(paged["outs"]) and not bad,
          f"phase 4n (4b): requests {bad} out of the order {LIFECYCLE_4B}")
    check(paged["eager_twin"]["timelines_identical"],
          "phase 4n (4b): the graphed engine's timelines differ from its "
          "eager twin's")
    sobs = swap["obs"]
    victims = sorted({d["victim_rid"] for d in swap["decisions"]
                      if d["mode"] == "swap"})
    vbad = [rid for rid in victims
            if not in_order(sobs["events"][sobs["uids"][rid]],
                            LIFECYCLE_SWAP)]
    ht = sobs["metrics"]["kv_cache"]["host_tier"]
    out_rows = registry_rows(sobs["snapshot"], "kv_cache.swapped_out_blocks",
                             pool=sobs["pool"])
    in_rows = registry_rows(sobs["snapshot"], "kv_cache.swapped_in_blocks",
                            pool=sobs["pool"])
    swapped = [int(r["value"]) for r in out_rows + in_rows]
    line["lifecycle_swap"] = {"victims": victims, "out_of_order": vbad,
                              "swapped_out_in_blocks": swapped}
    check(victims and not vbad,
          f"phase 4n (4m swap): victims {vbad} of {victims} out of the "
          f"order {LIFECYCLE_SWAP}")
    check(len(swapped) == 2 and swapped[0] == swapped[1]
          == ht["swapped_out_blocks"] > 0,
          f"phase 4n (4m swap): kv_cache.swapped_out / swapped_in "
          f"{swapped} vs the engine's {ht['swapped_out_blocks']}")
    series = {}
    for what, o in (("4b", obs), ("4c", int8["obs"]), ("4m_swap", sobs)):
        series[what] = metrics_vs_registry(o["metrics"], o["snapshot"],
                                           o["engine"], o["pool"])
    line["metrics_vs_registry"] = series
    check(not any(series.values()),
          f"phase 4n: metrics() differs from the registry: {series}")
    perf = {}
    for what, o in (("4b", obs), ("4c", int8["obs"]), ("4m_swap", sobs)):
        perf[what] = perf_fields(o, o["metrics"]["decode_ticks"],
                                 f"phase 4n ({what})")
    line["perf"] = perf
    check(perf["4m_swap"]["predicted_ms"]["swap_ms"] > 0,
          "phase 4n (4m swap): the cost model priced no swap traffic")
    line["chrome_trace"] = {"spans": obs["spans"],
                            "dropped": obs["trace_dropped"]}
    check(obs["spans"].get("serving.decode") == obs["metrics"]["decode_ticks"]
          and obs["trace_dropped"] == 0,
          f"phase 4n (4b): {obs['spans'].get('serving.decode')} "
          f"serving.decode spans for {obs['metrics']['decode_ticks']} "
          f"decode ticks ({obs['trace_dropped']} events dropped)")
    line["seconds"] = round(time.perf_counter() - t0, 4)
    emit(line)


# -- phase 4o ------------------------------------------------------------------------

# phase 4o's traffic: ``loadgen.LoadSpec`` fields (the vocabulary is the
# model's), its seed, and the router's replicas
ROUTER_SPEC = dict(n_requests=16, arrival="poisson", mean_gap=2.0,
                   prompt_dist="zipf", prompt_buckets=(64, 128, 256, 512),
                   prompt_zipf_a=1.1, prompt_min=16, prompt_max=512,
                   output_dist="lognormal", output_median=16,
                   output_sigma=0.4, output_min=8, output_max=24,
                   tenants=2, shared_prefix_len=512)
ROUTER_SEED = 11
ROUTER_REPLICAS = 2
# a replica's pool: 8 slots x 9 blocks (a 1048-token worst case) fit with
# the tenants' prefix blocks beside them, so no admission waits
ROUTER_POOL_BLOCKS = 96
ROUTER_MAX_LENGTH = 4096


def router_load(vocab: int):
    from paddle_tpu_torch.serving import LoadSpec, generate_load
    return generate_load(LoadSpec(vocab=vocab, **ROUTER_SPEC),
                         seed=ROUTER_SEED)


def router_run(torch, model, load):
    """One replay of ``load`` through ``ReplicaRouter(model,
    num_replicas=2, policy="prefix")`` over paged replicas of 8 slots:
    the observability layer reset, the router built (each replica's
    decode step built and captured), every launch and route counter reset
    just before the replay and read just after.  Returns the run: the
    replay's report, placements (``replica_of`` of every router rid),
    launches, routes, each replica's ``metrics()`` and wave keys, the
    router's aggregates, the registry's snapshot and Prometheus text, the
    placement events and each request's tenant (submission order), the
    HTTP bodies of ``/metrics`` and ``/healthz`` on a loopback exposition
    server, and whether the model's tensors stayed where they were."""
    from paddle_tpu_torch import observability, ops
    from paddle_tpu_torch.observability.http_exposition import (
        ExpositionServer)
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.serving import ReplicaRouter, replay

    observability.reset()
    ptrs = [(p.data_ptr(), p.dtype) for p in model.parameters()]
    router = ReplicaRouter(
        model, num_replicas=ROUTER_REPLICAS, policy="prefix",
        device="cuda", paged=True, block_len=128,
        num_blocks=ROUTER_POOL_BLOCKS, num_slots=8,
        max_length=ROUTER_MAX_LENGTH, prefill_batch=4)
    keys = [record_wave_keys(eng) for eng in router.engines]
    ticks = [record_tick_ms(eng) for eng in router.engines]
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = replay(router, load)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    log = observability.get_request_log()
    order = sorted(load, key=lambda r: (r.arrival, r.index))
    placed = []
    for (uid, rec), r in zip(
            log.records(rep["mark"], rep["end_mark"]).items(), order):
        ev = next((e["attrs"] for e in rec if e["name"] == "placed"), {})
        placed.append({"tenant": r.tenant, "replica": ev.get("replica"),
                       "route": ev.get("route"),
                       "warm_tokens": ev.get("warm_tokens")})
    retired = [e["attrs"] for rec in
               log.records(rep["mark"], rep["end_mark"]).values()
               for e in rec if e["name"] == "retired"]
    text = observability.default_registry().prometheus_text()
    with ExpositionServer(port=-1, engines=router.engines) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        http_metrics = urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode()
        http_healthz = urllib.request.urlopen(
            base + "/healthz", timeout=10).read().decode()
    run = {"report": rep, "wall": wall, "launches": launches,
           "routes": routes,
           "placements": [router.replica_of(r)
                          for r in sorted(router._placed)],
           "metrics": [eng.metrics() for eng in router.engines],
           "graphed": [eng.graphed for eng in router.engines],
           "wave_keys": keys, "tick_ms": ticks,
           "aggregate": router.metrics()["aggregate"],
           "snapshot": observability.snapshot(), "prometheus": text,
           "placed": placed, "retired": retired,
           "http_metrics": http_metrics, "http_healthz": http_healthz,
           "model_in_place": ptrs == [(p.data_ptr(), p.dtype)
                                      for p in model.parameters()]}
    del router
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_serving_router(torch, model):
    """Phase 4o: the single-host control plane at the Llama-3-8B width.
    Phase 3's model (bf16, 32 layers) behind ``ReplicaRouter(model,
    num_replicas=2, policy="prefix")`` of paged replicas (``block_len``
    128, 96 blocks, 8 slots, ``max_length`` 4096, ``prefill_batch`` 4),
    replaying ``generate_load`` 's seeded trace (16 requests, Poisson
    arrivals 2 ticks apart, two tenants each opening with a 512-token
    system prompt, Zipf prompts of 64-512 tokens after it, 8-24 new
    tokens), graphed, then on an eager twin router (``disable_graphs()``).
    Gates: outputs, placements, the replay's signature, ticks and
    rejections, launches and routes equal to the twin's; each replica
    built its decode step once, replayed a graph a decode tick and a
    prefill graph a wave, and built one prefill step a distinct wave key;
    K1-paged 32 a replica's decode tick, K2-paged 32 a wave, no other
    attention kernel, RMSNorm launched, no plain route, and the registry's
    ``ops.kernel_path`` holding the kernel routes of K1-paged, K2-paged
    and RMSNorm; ``router.prefix_routed_tokens`` > 0, a ``route="prefix"``
    placement, each prefix-routed request on a replica that served its
    tenant before, pooled prefix hits > 0; the model's tensors in place;
    ``/metrics`` of a loopback exposition server equal to the registry's
    ``prometheus_text()`` with the ``router.requests`` series, and
    ``/healthz`` parsing as JSON.  Reported: the replay's SLO report,
    TTFT / TPOT p50 / p90 (exact, from the request log), summed tok/s,
    ticks, wall seconds, requests a replica, each replica's
    ``decode_tick_ms`` (exact, :func:`record_tick_ms`) beside its
    registry's ``decode_step_ms`` (bucket readouts), the phase's
    seconds."""
    from paddle_tpu_torch.serving import disable_graphs

    t0 = time.perf_counter()
    what = "phase 4o"
    load = router_load(model.config.vocab_size)
    run = router_run(torch, model, load)
    with disable_graphs():
        twin = router_run(torch, model, load)
    rep, trep = run["report"], twin["report"]
    ms = run["metrics"]
    total = {"decode_ticks": sum(m["decode_ticks"] for m in ms),
             "prefill_waves": sum(m["prefill_waves"] for m in ms),
             "ticks": sum(m["ticks"] for m in ms)}
    routes_reg = {f"{r['labels']['op']}/{r['labels']['path']}":
                  int(r["value"]) for r in
                  registry_rows(run["snapshot"], "ops.kernel_path")}
    by_route = {}
    for r in registry_rows(run["snapshot"], "router.requests"):
        route = r["labels"]["route"]
        by_route[route] = by_route.get(route, 0) + int(r["value"])
    seen, stray = {}, []
    for i, p in enumerate(run["placed"]):
        if p["route"] == "prefix" and p["replica"] not in seen.get(
                p["tenant"], set()):
            stray.append(i)
        seen.setdefault(p["tenant"], set()).add(p["replica"])
    agg = run["aggregate"]
    hits = sum(m["kv_cache"]["prefix_hit_tokens"] for m in ms)
    healthz = json.loads(run["http_healthz"])
    twin_same = {
        "outputs": rep["outputs"] == trep["outputs"],
        "placements": run["placements"] == twin["placements"],
        "signature": rep["signature"] == trep["signature"],
        "ticks": rep["ticks"] == trep["ticks"],
        "rejected": rep["rejected"] == trep["rejected"],
        "launches": run["launches"] == twin["launches"],
        "routes": run["routes"] == twin["routes"]}
    gen = rep["generated_tokens"]
    line = {
        "phase": "serving_router", "replicas": ROUTER_REPLICAS,
        "policy": "prefix", "requests": len(load),
        "prompt_lengths": [int(r.prompt.size) for r in load],
        "new_tokens": [r.max_new_tokens for r in load],
        "block_len": 128, "num_blocks": ROUTER_POOL_BLOCKS,
        "ticks": rep["ticks"], "rejected": rep["rejected"],
        "generated_tokens": gen, "wall_s": round(run["wall"], 4),
        "tok_per_s": round(gen / run["wall"], 2),
        "eager_wall_s": round(twin["wall"], 4),
        "eager_tok_per_s": round(gen / twin["wall"], 2),
        "slo": rep["slo"],
        "ttft_ms": exact_summary([a["ttft_ms"] for a in run["retired"]
                                  if a.get("ttft_ms") is not None]),
        "tpot_ms": exact_summary([a["tpot_ms"] for a in run["retired"]
                                  if a.get("tpot_ms") is not None]),
        "per_replica": [
            {"requests": m["requests_submitted"],
             "tokens": m["tokens_generated"], "ticks": m["ticks"],
             "decode_ticks": m["decode_ticks"],
             "prefill_waves": m["prefill_waves"],
             "step_traces": m["step_traces"],
             "graph_replays": m["graph_replays"],
             "prefill_traces": m["prefill_traces"],
             "prefill_graph_replays": m["prefill_graph_replays"],
             "wave_keys": sorted(set(k)),
             "prefix_hit_tokens": m["kv_cache"]["prefix_hit_tokens"],
             "decode_tick_ms": exact_summary(t),
             "decode_step_ms": m["decode_step_ms"]}
            for m, k, t in zip(ms, run["wave_keys"], run["tick_ms"])],
        "prefix_routed_tokens": agg["prefix_routed_tokens"],
        "prefix_hit_rate_pooled": agg.get("prefix_hit_rate_pooled"),
        "requests_by_route": by_route, "launches": run["launches"],
        "routes": run["routes"], "registry_routes": routes_reg,
        "eager_twin_identical": twin_same,
        "http": {"metrics_equal_registry":
                 run["http_metrics"] == run["prometheus"],
                 "metrics_bytes": len(run["http_metrics"]),
                 "healthz": healthz}}
    for k, same in twin_same.items():
        check(same, f"{what}: the eager twin's {k} differ from the "
                    f"graphed router's")
    for i, (m, k) in enumerate(zip(ms, run["wave_keys"])):
        check_graph({"graphed": run["graphed"][i], "metrics": m,
                     "wave_keys": k}, f"{what} replica {i}")
    for i, (m, k) in enumerate(zip(twin["metrics"], twin["wave_keys"])):
        check_graph({"graphed": twin["graphed"][i], "metrics": m,
                     "wave_keys": k}, f"{what} eager replica {i}",
                    graphed=False)
    check(rep["rejected"] == 0 and all(rep["outputs"]),
          f"{what}: {rep['rejected']} requests rejected")
    check(all(len(o) == r.max_new_tokens
              and all(0 <= t < model.config.vocab_size for t in o)
              for o, r in zip(rep["outputs"], load)),
          f"{what}: a request returned the wrong count of tokens or a "
          f"token outside the vocabulary")
    check_attention_launches(what, run["launches"], run["routes"],
                             attention_launches(total, {
                                 "decode_attention_paged": ("tick",),
                                 "flash_attention_fwd_paged": ("wave",)}))
    for op in OBS_ROUTES["4b"]:
        check(routes_reg.get(f"{op}/kernel", 0) > 0,
              f"{what}: no kernel route for {op} in the registry (a plain "
              f"route ran)")
    plain = {k: n for k, n in routes_reg.items() if k.endswith("/plain")}
    check(not plain, f"{what}: plain routes in the registry: {plain}")
    check(agg["prefix_routed_tokens"] > 0 and by_route.get("prefix", 0) > 0,
          f"{what}: no request was routed by its prefix "
          f"(prefix_routed_tokens {agg['prefix_routed_tokens']}, routes "
          f"{by_route})")
    check(not stray, f"{what}: prefix-routed requests {stray} landed on a "
                     f"replica that never served their tenant")
    check(hits > 0, f"{what}: no pooled prefix hit")
    check(run["model_in_place"] and twin["model_in_place"],
          f"{what}: building the replicas moved or cast the model")
    check(run["http_metrics"] == run["prometheus"]
          and "router_requests" in run["http_metrics"],
          f"{what}: /metrics differs from the registry's text or lacks "
          f"the router.requests series")
    check(isinstance(healthz, dict) and "ok" in healthz,
          f"{what}: /healthz is not the liveness JSON: {healthz}")
    line["seconds"] = round(time.perf_counter() - t0, 4)
    emit(line)


# -- phase 4p ------------------------------------------------------------------------

# phase 4p's traffic (``loadgen.LoadSpec`` fields; the vocabulary is the
# model's) and seed: requests of at most 384 prompt tokens, so a
# migration moves at most 3 blocks (48 MiB at the 8B width)
MULTIHOST_SPEC = dict(n_requests=8, arrival="poisson", mean_gap=2.0,
                      prompt_dist="zipf", prompt_buckets=(64, 128, 256),
                      prompt_zipf_a=1.1, prompt_min=16, prompt_max=256,
                      output_dist="lognormal", output_median=16,
                      output_sigma=0.4, output_min=8, output_max=24,
                      tenants=2, shared_prefix_len=128)
MULTIHOST_SEED = 13
MULTIHOST_WORKERS = ("p0", "d0", "d1")
# a worker's pool: 8 slots x 4 blocks (a 408-token worst case) beside the
# tenants' prefix blocks
MULTIHOST_POOL_BLOCKS = 40
MULTIHOST_MAX_LENGTH = 2048
# the failover leg kills d1 at the first tick from this one at which it
# holds a request
MULTIHOST_KILL_TICK = 6
# the real-process self-check: extra arguments (none: the card) and its
# time limit in seconds
MULTIHOST_SELFCHECK_ARGS = ()
MULTIHOST_SELFCHECK_TIMEOUT = 300


def multihost_load(vocab: int):
    from paddle_tpu_torch.serving import LoadSpec, generate_load
    return generate_load(LoadSpec(vocab=vocab, **MULTIHOST_SPEC),
                         seed=MULTIHOST_SEED)


def metered_workers(model, names, engines=None):
    """A loopback transport a worker over ``engines`` (name -> engine;
    fresh paged engines of phase 4p's shape by default).  Each worker's
    handler credits the kernel launches made inside its calls to that
    worker (``launches``: name -> Counter) and sums its seconds by method
    (``handler_s``); each transport sums the seconds of its calls by
    method, the codec's both ways included (``call_s``).  Returns
    (transports, engines, launches, call_s, handler_s)."""
    from collections import OrderedDict

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.multihost import (EngineWorker,
                                                    LoopbackTransport)

    if engines is None:
        engines = {n: ServingEngine(
            model, device="cuda", paged=True, block_len=128,
            num_blocks=MULTIHOST_POOL_BLOCKS, num_slots=8,
            max_length=MULTIHOST_MAX_LENGTH, prefill_batch=4)
            for n in names}
    launches = {n: collections.Counter() for n in names}
    call_s, handler_s = collections.Counter(), collections.Counter()
    transports = OrderedDict()
    for n in names:
        def handle(method, payload, _h=EngineWorker(engines[n], name=n)
                   .handle, _n=n):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            try:
                return _h(method, payload)
            finally:
                handler_s[method] += time.perf_counter() - t0
                after = ops.launch_counts()
                launches[_n].update({k: after[k] - before[k]
                                     for k in after if after[k] > before[k]})
        t = LoopbackTransport(handle, name=n)

        def call(method, payload=None, timeout=None, _call=t.call):
            t0 = time.perf_counter()
            try:
                return _call(method, payload, timeout)
            finally:
                call_s[method] += time.perf_counter() - t0
        t.call = call
        transports[n] = t
    return transports, engines, launches, call_s, handler_s


def stream_generate(plane, prompt, new_tokens):
    """One ``POST /v1/generate`` through a ``ServingFrontend`` over
    ``plane`` on a loopback server: the streamed lines, whether the
    request had retired when its first token chunk was read, and the
    plane's ``result`` of it."""
    import http.client

    from paddle_tpu_torch.serving.multihost import ServingFrontend

    fe = ServingFrontend(plane)
    srv = fe.serve(port=-1)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=300)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [int(t) for t in prompt],
             "max_new_tokens": int(new_tokens)}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        lines, buf, retired_at_first = [], b"", None
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    lines.append(json.loads(line))
                    if "tokens" in lines[-1] and retired_at_first is None:
                        retired_at_first = plane._reqs[
                            lines[0]["rid"]].done
        conn.close()
    finally:
        srv.stop()
        fe.stop()
    result = plane.result(lines[0]["rid"]) if lines and "rid" in lines[0] \
        else None
    return {"status": resp.status, "lines": lines,
            "retired_at_first_chunk": retired_at_first, "result": result}


def multihost_run(torch, model, load, http_leg=True):
    """One replay of ``load`` through ``MultiHostRouter(policy="disagg",
    prefill=["p0"])`` over :func:`metered_workers`: the observability
    layer reset, every launch and route counter reset just before the
    replay and read just after.  Returns the run: the replay's report,
    placements, launches (all, and each worker's), routes, each engine's
    ``metrics()`` and wave keys, the plane's aggregates, the request log's
    records of the run, the exported blocks' bytes, the seconds of the
    migration calls, the federation (counters against the registry, the
    merged trace's tracks), and with ``http_leg`` the ``/fleet`` and
    ``/metrics`` bodies and one streamed generation; the engines stay in
    the run (the failover leg reuses the twin's)."""
    from paddle_tpu_torch import observability, ops
    from paddle_tpu_torch.observability.http_exposition import (
        ExpositionServer)
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.serving import replay
    from paddle_tpu_torch.serving.multihost import MultiHostRouter

    observability.reset()
    ptrs = [(p.data_ptr(), p.dtype) for p in model.parameters()]
    transports, engines, per_worker, call_s, handler_s = metered_workers(
        model, MULTIHOST_WORKERS)
    keys = {n: record_wave_keys(e) for n, e in engines.items()}
    plane = MultiHostRouter(transports, policy="disagg", prefill=["p0"])
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    for c in per_worker.values():
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = replay(plane, load)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    log = observability.get_request_log()
    records = log.records(rep["mark"], rep["end_mark"])
    rids = sorted(plane._reqs)
    block_bytes = sum(t[:, :, 0].numel() * t.element_size()
                      for t in engines["d0"]._leaves())
    run = {"report": rep, "wall": wall, "launches": launches,
           "per_worker": {n: dict(c) for n, c in per_worker.items()},
           "routes": routes,
           "worker_of": [plane.worker_of(r) for r in rids],
           "metrics": {n: e.metrics() for n, e in engines.items()},
           "graphed": {n: e.graphed for n, e in engines.items()},
           # copies: the failover leg's waves on the twin's engines
           # append to the recorders after this run
           "wave_keys": {n: list(k) for n, k in keys.items()},
           "aggregate": plane.metrics()["aggregate"],
           "records": records, "block_bytes": block_bytes,
           "migration_s": call_s["export_request"]
           + call_s["import_request"],
           "migration_handler_s": handler_s["export_request"]
           + handler_s["import_request"],
           "snapshot": observability.snapshot(), "engines": engines}
    # federation: the plane's pooled counters against the workers' own
    # series in this process's registry
    merged = plane.federation().merged()
    eids = {str(e._eid) for e in engines.values()}
    bad, n_counters = [], 0
    for name, fam in merged.items():
        if name in ("schema_version", "workers") or fam["type"] != "counter":
            continue
        n_counters += 1
        want = sum(float(r["value"]) for r in
                   run["snapshot"].get(name, {}).get("series", [])
                   if str(r["labels"].get("engine", "")) in eids)
        if float(fam["pooled"]["value"]) != want:
            bad.append(f"{name}: {fam['pooled']['value']} != {want}")
    trace = plane.export_merged_perfetto(since_uid=rep["mark"],
                                         until_uid=rep["end_mark"])
    evs = trace["traceEvents"]
    run["federation"] = {
        "counter_families": n_counters, "counters_differing": bad,
        "process_tracks": sorted(e["args"]["name"] for e in evs
                                 if e.get("name") == "process_name"),
        "stitched_request_slices": sum(
            1 for e in evs if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("on ")),
        "trace_bytes": len(json.dumps(trace))}
    if http_leg:
        with ExpositionServer(port=-1, engines=[plane]) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            run["http_fleet"] = urllib.request.urlopen(
                base + "/fleet", timeout=30).read().decode()
            run["http_metrics"] = urllib.request.urlopen(
                base + "/metrics", timeout=30).read().decode()
        first = min(load, key=lambda r: (r.arrival, r.index))
        run["stream"] = stream_generate(plane, first.prompt, 8)
    run["model_in_place"] = ptrs == [(p.data_ptr(), p.dtype)
                                     for p in model.parameters()]
    return run


def failover_run(torch, engines, load):
    """The failover leg on ``engines``' d0 and d1 (drained): the trace
    through ``MultiHostRouter(policy="prefix")`` over fresh workers,
    ``d1`` killed at the first tick from ``MULTIHOST_KILL_TICK`` at which
    it holds a request.  Returns the outputs (trace order), the tick of
    the kill and each request's event names."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.serving.multihost import MultiHostRouter

    observability.reset()
    transports = metered_workers(None, ("d0", "d1"), engines)[0]
    plane = MultiHostRouter(transports, policy="prefix")
    order = sorted(load, key=lambda r: (r.arrival, r.index))
    rids, tick, nxt, killed = {}, 0, 0, None
    t0 = time.perf_counter()
    while nxt < len(order) or any(not r.done
                                  for r in plane._reqs.values()):
        while nxt < len(order) and order[nxt].arrival <= tick:
            r = order[nxt]
            rids[r.index] = plane.submit(r.prompt,
                                         max_new_tokens=r.max_new_tokens)
            nxt += 1
        plane.step()
        tick += 1
        if killed is None and tick >= MULTIHOST_KILL_TICK and any(
                q.worker == "d1" and not q.done
                for q in plane._reqs.values()):
            plane._workers["d1"].kill()
            killed = tick
    torch.cuda.synchronize()
    log = observability.get_request_log()
    return {"outputs": [plane.result(rids[r.index]) for r in load],
            "killed_at_tick": killed, "ticks": tick,
            "wall": time.perf_counter() - t0,
            "lost": plane.lost_workers,
            "failovers": plane.metrics()["aggregate"]["failovers"],
            "events": [log.event_names(plane.request_uid(rids[r.index]))
                       for r in load]}


def run_selfcheck():
    """``python -m paddle_tpu_torch.serving.multihost --selfcheck`` (with
    ``MULTIHOST_SELFCHECK_ARGS``) in a process group of its own: its exit
    code, its output's tail and its seconds; on the time limit the whole
    group (the self-check and its worker processes) is killed."""
    import os
    import signal
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                       else []))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.multihost",
         "--selfcheck", *MULTIHOST_SELFCHECK_ARGS], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=MULTIHOST_SELFCHECK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    return {"rc": proc.returncode, "seconds": round(
        time.perf_counter() - t0, 3), "passed": "[selfcheck] PASS" in out,
        "tail": out[-3000:]}


def phase_serving_multihost(torch, model, card):
    """Phase 4p: the multihost plane at the Llama-3-8B width.  Phase 3's
    model (bf16, 32 layers) behind three ``EngineWorker`` s over loopback
    transports, each a paged engine (``block_len`` 128,
    ``MULTIHOST_POOL_BLOCKS`` blocks, 8 slots, ``max_length`` 2048,
    ``prefill_batch`` 4), replaying ``generate_load`` 's seeded trace (8
    requests, Poisson arrivals 2 ticks apart, two tenants each opening
    with a 128-token system prompt, then 64-256 tokens, 8-24 new tokens)
    through ``MultiHostRouter(policy="disagg", prefill=["p0"])``, graphed,
    then on an eager twin plane (``disable_graphs()``).  Gates: outputs,
    placements, the timeline signature, ticks and rejections equal to the
    twin's; every request placed on p0 and finished on d0 or d1;
    ``multihost.migrations`` 8 and ``multihost.migration_bytes`` the
    migrated blocks times a block's bytes from the pool's leaf shapes,
    each migration the blocks its exporter logged, at least its prompt's
    and at most its whole request's; p0 K2-paged 32 a wave,
    d0 and d1 K1-paged 32 a tick and no wave (launches credited to the
    worker whose call made them); each engine's decode step built once
    and replayed a tick, a prefill replay a wave and one build a wave key,
    no prefill build on d0 / d1; no plain route and the registry's kernel
    routes of K1-paged, K2-paged and RMSNorm; the model's tensors in
    place.  The failover leg (eager: the twin's d0 and d1 behind
    ``policy="prefix"``, d1 killed at a fixed tick while it holds
    requests): every request finishes with its whole budget, each
    victim's timeline one ``submitted``, then ``worker_lost``,
    ``failover``, ``placed``, and a ``retired`` last; its tokens'
    agreement with the disagg leg reported (bf16: a recompute runs
    K2-paged where the victim ran K1-paged, so a near-tie may flip).
    Federation: pooled counters equal the workers' series, the merged
    Perfetto trace a process track a worker and stitched request
    slices, ``/fleet`` JSON with three live workers and ``/metrics`` with
    ``worker=`` labels over a loopback server, one ``POST /v1/generate``
    streaming its first token chunk before the request retires, the
    streamed tokens ``plane.result``'s.  The real-process self-check
    (:func:`run_selfcheck`) exits 0 and prints PASS.  Reported: the
    seconds of the migration calls (codec included) and of their
    handlers, ticks, tok/s (graphed, eager), TTFT (p0's ``first_token``
    events) and TPOT (the decode workers' retirements, timed from the
    import) p50 / p90, exact, from the request log, the self-check's and
    the phase's seconds, beside the card's name and power limit."""
    from paddle_tpu_torch.serving import disable_graphs

    t0 = time.perf_counter()
    what = "phase 4p"
    load = multihost_load(model.config.vocab_size)
    run = multihost_run(torch, model, load)
    with disable_graphs():
        twin = multihost_run(torch, model, load, http_leg=False)
        fo = failover_run(torch, {n: twin["engines"][n]
                                  for n in ("d0", "d1")}, load)
    for r in (run, twin):
        r.pop("engines")
    gc.collect()
    torch.cuda.empty_cache()
    selfcheck = run_selfcheck()
    rep, trep = run["report"], twin["report"]
    ms = run["metrics"]
    twin_same = {
        "outputs": rep["outputs"] == trep["outputs"],
        "worker_of": run["worker_of"] == twin["worker_of"],
        "signature": rep["signature"] == trep["signature"],
        "ticks": rep["ticks"] == trep["ticks"],
        "rejected": rep["rejected"] == trep["rejected"],
        "launches": run["launches"] == twin["launches"],
        "per_worker_launches": run["per_worker"] == twin["per_worker"],
        "routes": run["routes"] == twin["routes"]}
    for k, same in twin_same.items():
        check(same, f"{what}: the eager twin's {k} differ from the "
                    f"graphed plane's")
    check(rep["rejected"] == 0 and all(rep["outputs"]),
          f"{what}: {rep['rejected']} requests rejected")
    check(all(len(o) == r.max_new_tokens
              and all(0 <= t < model.config.vocab_size for t in o)
              for o, r in zip(rep["outputs"], load)),
          f"{what}: a request returned the wrong count of tokens or a "
          f"token outside the vocabulary")
    # placements and migrations, from the request log
    placed_first, migrated_blocks, exported_blocks = [], [], []
    for rec in run["records"].values():
        ev = [e for e in rec if e["name"] == "placed"]
        placed_first.append(ev[0]["attrs"].get("worker") if ev else None)
        migrated_blocks += [e["attrs"]["blocks"] for e in rec
                            if e["name"] == "migrated"]
        exported_blocks += [e["attrs"]["blocks"] for e in rec
                            if e["name"] == "exported"]
    check(placed_first == ["p0"] * len(load),
          f"{what}: requests placed on {placed_first}, want all on p0")
    check(all(w in ("d0", "d1") for w in run["worker_of"]),
          f"{what}: requests finished on {run['worker_of']}")
    agg = run["aggregate"]
    # a migration carries the exporter's whole chain: the prompt's blocks
    # and, where the next token's position opens a block, that one too
    order = sorted(load, key=lambda r: (r.arrival, r.index))
    spans = [(-(-int(r.prompt.size) // 128),
              -(-(int(r.prompt.size) + r.max_new_tokens) // 128))
             for r in order]
    check(agg["migrations"] == len(load)
          and migrated_blocks == exported_blocks
          and len(migrated_blocks) == len(spans)
          and all(lo <= b <= hi for b, (lo, hi) in
                  zip(migrated_blocks, spans)),
          f"{what}: {agg['migrations']} migrations of {migrated_blocks} "
          f"blocks (exported {exported_blocks}), want {len(load)} within "
          f"{spans} (the prompt's blocks up to the whole request's)")
    want_bytes = sum(migrated_blocks) * run["block_bytes"]
    check(agg["migration_bytes"] == want_bytes,
          f"{what}: multihost.migration_bytes {agg['migration_bytes']}, "
          f"want {want_bytes} ({sum(migrated_blocks)} blocks of "
          f"{run['block_bytes']} bytes)")
    # launches, each worker's own, and the steps' builds and replays
    for n in MULTIHOST_WORKERS:
        m, got = ms[n], run["per_worker"][n]
        want = {"decode_attention_paged": LAYERS_8B * m["decode_ticks"],
                "flash_attention_fwd_paged": LAYERS_8B * m["prefill_waves"]}
        for k, v in want.items():
            check(got.get(k, 0) == v,
                  f"{what}: {n} launched {k} {got.get(k, 0)} times, want "
                  f"{v} (32 a {'tick' if 'decode' in k else 'wave'})")
        others = [k for k in ATTENTION_KERNELS
                  if k not in want and got.get(k)]
        check(not others, f"{what}: {n} ran attention kernels off its "
                          f"path: {others}")
        check_graph({"graphed": run["graphed"][n], "metrics": m,
                     "wave_keys": run["wave_keys"][n]}, f"{what} {n}")
        check_graph({"graphed": twin["graphed"][n],
                     "metrics": twin["metrics"][n],
                     "wave_keys": twin["wave_keys"][n]},
                    f"{what} eager {n}", graphed=False)
    check(ms["p0"]["prefill_waves"] > 0,
          f"{what}: p0 ran no prefill wave")
    for n in ("d0", "d1"):
        check(ms[n]["prefill_waves"] == 0 and ms[n]["prefill_traces"] == 0
              and ms[n]["decode_ticks"] > 0,
              f"{what}: decode worker {n} ran {ms[n]['prefill_waves']} "
              f"waves ({ms[n]['prefill_traces']} prefill builds) and "
              f"{ms[n]['decode_ticks']} decode ticks")
    check(run["launches"]["rms_norm"] > 0,
          f"{what}: RMSNorm kernel not launched")
    routes_reg = {f"{r['labels']['op']}/{r['labels']['path']}":
                  int(r["value"]) for r in
                  registry_rows(run["snapshot"], "ops.kernel_path")}
    for op in OBS_ROUTES["4b"]:
        check(routes_reg.get(f"{op}/kernel", 0) > 0,
              f"{what}: no kernel route for {op} in the registry (a plain "
              f"route ran)")
    plain = {k: n for k, n in list(routes_reg.items())
             + list(run["routes"].items()) if k.endswith("/plain")}
    check(not plain, f"{what}: plain routes taken on the card: {plain}")
    check(run["model_in_place"] and twin["model_in_place"],
          f"{what}: building the workers moved or cast the model")
    # the failover leg
    victims = [i for i, names in enumerate(fo["events"])
               if "worker_lost" in names]
    check(fo["killed_at_tick"] is not None and list(fo["lost"]) == ["d1"]
          and victims,
          f"{what}: the failover leg killed at {fo['killed_at_tick']}, lost "
          f"{fo['lost']}, victims {victims}")
    check(all(len(o) == r.max_new_tokens
              for o, r in zip(fo["outputs"], load)),
          f"{what}: a request of the failover leg did not finish its "
          f"budget: {[len(o) for o in fo['outputs']]}")
    for i in victims:
        names = fo["events"][i]
        ok = (names.count("submitted") == 1 and names[0] == "submitted"
              and names[-1] == "retired"
              and in_order(names, ("worker_lost", "failover"))
              and max(j for j, x in enumerate(names) if x == "placed")
              > names.index("failover"))
        check(ok, f"{what}: victim {i}'s timeline {names}")
    agree = twin_comparison(rep["outputs"], fo["outputs"])
    # federation and HTTP
    fed = run["federation"]
    check(fed["counter_families"] > 0 and not fed["counters_differing"],
          f"{what}: federated counters differ from the workers' series: "
          f"{fed['counters_differing'][:5]}")
    check({f"paddle_tpu worker {n}" for n in MULTIHOST_WORKERS}
          <= set(fed["process_tracks"])
          and fed["stitched_request_slices"] > 0,
          f"{what}: merged trace tracks {fed['process_tracks']}, "
          f"{fed['stitched_request_slices']} stitched request slices")
    fleet = json.loads(run["http_fleet"])
    check(all(fleet["workers"].get(n, {}).get("alive")
              for n in MULTIHOST_WORKERS),
          f"{what}: /fleet does not report three live workers: {fleet}")
    check(all(f'worker="{n}"' in run["http_metrics"]
              for n in MULTIHOST_WORKERS)
          and "paddle_tpu_fleet_" in run["http_metrics"],
          f"{what}: /metrics lacks the federated worker series")
    st = run["stream"]
    streamed = [t for ln in st["lines"] for t in ln.get("tokens", [])]
    check(st["status"] == 200 and st["retired_at_first_chunk"] is False
          and streamed == st["result"] and len(streamed) == 8
          and st["lines"][-1].get("done") is True,
          f"{what}: the streamed generation: status {st['status']}, "
          f"retired at its first chunk {st['retired_at_first_chunk']}, "
          f"{len(streamed)} tokens streamed, equal to the result "
          f"{streamed == st['result']}")
    check(selfcheck["rc"] == 0 and selfcheck["passed"],
          f"{what}: the multihost self-check exited {selfcheck['rc']}: "
          f"{selfcheck['tail'][-1500:]}")
    # TTFT from the prefill worker's first_token events (a decode
    # worker's clock restarts at the import); TPOT from the decode
    # workers' retirements, from the import on
    first = [e["attrs"] for rec in run["records"].values() for e in rec
             if e["name"] == "first_token"]
    retired = [e["attrs"] for rec in run["records"].values() for e in rec
               if e["name"] == "retired"]
    gen = rep["generated_tokens"]
    line = {
        "phase": "serving_multihost", "card": card,
        "workers": list(MULTIHOST_WORKERS), "policy": "disagg",
        "requests": len(load),
        "prompt_lengths": [int(r.prompt.size) for r in load],
        "new_tokens": [r.max_new_tokens for r in load],
        "block_len": 128, "num_blocks": MULTIHOST_POOL_BLOCKS,
        "ticks": rep["ticks"], "rejected": rep["rejected"],
        "generated_tokens": gen, "wall_s": round(run["wall"], 4),
        "tok_per_s": round(gen / run["wall"], 2),
        "eager_wall_s": round(twin["wall"], 4),
        "eager_tok_per_s": round(gen / twin["wall"], 2),
        "ttft_ms": exact_summary([a["ttft_ms"] for a in first
                                  if a.get("ttft_ms") is not None]),
        "tpot_ms": exact_summary([a["tpot_ms"] for a in retired
                                  if a.get("tpot_ms") is not None]),
        "migrations": agg["migrations"],
        "migration_bytes": agg["migration_bytes"],
        "migrated_blocks": migrated_blocks,
        "prompt_blocks": [lo for lo, _ in spans],
        "block_bytes": run["block_bytes"],
        "migration_s": round(run["migration_s"], 4),
        "migration_handler_s": round(run["migration_handler_s"], 4),
        "eager_migration_s": round(twin["migration_s"], 4),
        "per_worker": {
            n: {"launches": run["per_worker"][n],
                "requests": m["requests_submitted"],
                "tokens": m["tokens_generated"], "ticks": m["ticks"],
                "decode_ticks": m["decode_ticks"],
                "prefill_waves": m["prefill_waves"],
                "step_traces": m["step_traces"],
                "graph_replays": m["graph_replays"],
                "prefill_traces": m["prefill_traces"],
                "prefill_graph_replays": m["prefill_graph_replays"],
                "decode_step_ms": m["decode_step_ms"]}
            for n, m in ms.items()},
        "launches": run["launches"], "routes": run["routes"],
        "registry_routes": routes_reg,
        "eager_twin_identical": twin_same,
        "failover": {"killed_at_tick": fo["killed_at_tick"],
                     "ticks": fo["ticks"], "victims": victims,
                     "failovers": fo["failovers"],
                     "wall_s": round(fo["wall"], 4),
                     "agreement_with_disagg": agree},
        "federation": fed,
        "http": {"fleet_workers": sorted(fleet["workers"]),
                 "metrics_bytes": len(run["http_metrics"]),
                 "stream_lines": len(st["lines"]),
                 "stream_tokens": len(streamed)},
        "selfcheck": {k: selfcheck[k] for k in ("rc", "seconds",
                                                "passed")}}
    line["seconds"] = round(time.perf_counter() - t0, 4)
    emit(line)


def cancel_states(torch, model, prompts):
    """``cancel`` in the five states, on a chunked engine
    (``PREEMPT_CHUNK``-token chunks) in each mode: the preempted request (swapped out, or awaiting
    its recompute re-prefill), the arrival mid chunked prefill, a queued
    request and a decoding one; then the drain.  Gates: each cancel finds
    its request, no block in use and ``host_blocks_used()`` =
    ``host_trie_blocks()`` after the drain, ``cancelled`` 4."""
    for mode, extra in (("swap", {"host_blocks": PREEMPT_HOST_BLOCKS}),
                        ("recompute", {})):
        what = f"phase 4m cancel ({mode})"
        eng = _preempt_engine(model, chunked=True,
                              prefill_chunk=PREEMPT_CHUNK, preempt=mode,
                              **extra)
        for p in prompts[:2]:
            eng.submit(p, max_new_tokens=32, priority=0)
        for _ in range(10):
            eng.step()
        for p in prompts[2:]:
            eng.submit(p, max_new_tokens=32, priority=5)
        for _ in range(20):
            if eng.preempt_decisions:
                break
            eng.step()
        found = {}
        check(eng.num_preempted == 1, f"{what}: no request awaits resume")
        found["preempted"] = eng.cancel(eng.preempt_decisions[0][
            "victim_rid"])
        pf = eng._cursor
        found["prefill"] = pf is not None and eng.cancel(pf.req.request_id)
        found["queued"] = eng.cancel(eng.submit(prompts[3][:300],
                                                max_new_tokens=8))
        live = [s.rid for s in eng._slots if s is not None]
        found["decoding"] = bool(live) and eng.cancel(live[0])
        eng.drain()
        m = eng.metrics()
        line = {"phase": "serving_preempt_cancel", "mode": mode,
                "found": found, "cancelled": m["cancelled"],
                "blocks_in_use": eng.kv.blocks_in_use(),
                "host_blocks_used": eng.kv.host_blocks_used(),
                "host_trie_blocks": eng.kv.host_trie_blocks(),
                "step_traces": m["step_traces"], "graphed": eng.graphed}
        emit(line)
        check(all(found.values()), f"{what}: cancels found {found}")
        check(m["cancelled"] == 4, f"{what}: cancelled {m['cancelled']}")
        check(line["blocks_in_use"] == 0
              and line["host_blocks_used"] == line["host_trie_blocks"],
              f"{what}: after the drain {line}")
        check(m["step_traces"] == 1 and eng.graphed,
              f"{what}: step_traces {m['step_traces']}, graphed "
              f"{eng.graphed}")
        del eng


def host_tier_run(torch, model):
    """The host tier at 128-token blocks: a one-slot engine over a 6-block
    pool serves a request opening with a 256-token system prompt, two
    unique requests that evict its blocks (to the host tier, 4 blocks),
    then a second request opening with the system prompt, whose admission
    promotes them.  Gates: ``host_demotions`` and ``host_promotions`` > 0,
    tokens equal to the same engine's without a tier."""
    import numpy as np
    rng = np.random.RandomState(6)
    vocab = model.config.vocab_size
    system = rng.randint(0, vocab, 256).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(0, vocab, 48).astype(
        np.int32)]), rng.randint(0, vocab, 320).astype(np.int32),
        rng.randint(0, vocab, 352).astype(np.int32),
        np.concatenate([system, rng.randint(0, vocab, 80).astype(
            np.int32)])]
    outs = {}
    for hb in (4, 0):
        eng = _preempt_engine(model, num_slots=1, prefill_batch=1,
                              num_blocks=7, host_blocks=hb)
        rids = [eng.submit(p, max_new_tokens=HOST_TIER_NEW_TOKENS)
                for p in prompts]
        out = dict(eng.drain())
        outs[hb] = [out[r] for r in rids]
        if hb:
            st, m = eng.kv.stats, eng.metrics()
        del eng
    what = "phase 4m host tier"
    line = {"phase": "serving_host_tier",
            "prompt_lengths": [int(p.size) for p in prompts],
            "num_blocks": 7, "host_blocks": 4,
            "host_tier": m["kv_cache"]["host_tier"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "evictions": st["evictions"],
            "tokens_identical_to_no_tier": outs[4] == outs[0],
            "step_traces": m["step_traces"]}
    emit(line)
    check(st["host_demotions"] > 0 and st["host_promotions"] > 0,
          f"{what}: demotions {st['host_demotions']}, promotions "
          f"{st['host_promotions']}")
    check(outs[4] == outs[0], f"{what}: tokens differ from the run without "
          f"a tier")


def migration_run(torch, model, prompts):
    """``export_request`` of a decoding request (the first of
    :func:`preempt_prompts`, 32 new tokens, after 8 ticks) from one engine
    with ``release=False`` (it keeps decoding: the unmigrated run) and
    ``import_request`` into a second engine over the same model.  Gates:
    the importer's tokens equal the exporter's; the record's blocks and
    bytes."""
    what = "phase 4m migration"
    src = _preempt_engine(model)
    rid = src.submit(prompts[0], max_new_tokens=32)
    for _ in range(8):
        src.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record = src.export_request(rid, release=False)
    export_ms = (time.perf_counter() - t0) * 1e3
    dst = _preempt_engine(model)
    t0 = time.perf_counter()
    rid2 = dst.import_request(record)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    check(rid2 is not None, f"{what}: the import found no room")
    dst.drain()
    src.drain()
    line = {"phase": "serving_migration",
            "prompt_length": int(prompts[0].size),
            "exported_at_tokens": len(record["generated"]),
            "blocks": len(record["blocks"]["entries"]),
            "payload_bytes": record["payload_bytes"],
            "export_ms": round(export_ms, 3),
            "import_ms": round(import_ms, 3),
            "tokens_identical": src.result(rid) == dst.result(rid2),
            "dst_blocks_in_use": dst.kv.blocks_in_use()}
    emit(line)
    check(line["tokens_identical"] and len(dst.result(rid2)) == 32,
          f"{what}: the imported request's tokens differ from the "
          f"unmigrated run's")
    check(line["dst_blocks_in_use"] == 0, f"{what}: blocks in use")


def tiny_tiers_card_vs_cpu(torch):
    """The float32 tiny engines with the memory tiers, card against CPU
    (as the ``model_tiny_f32*`` lines): the swap (a 16-block host tier)
    and recompute engines on ``tests/test_serving_preempt.py``'s
    saturating traffic (13 blocks of 8, max_length 64), wave and chunked
    (8-token chunks), and the mixed engine on the paged tiny prompts
    (block_len 16, a shared 20-token prompt).  Gates: tokens and
    preemption decisions equal card vs CPU, each card engine graphed with
    ``step_traces`` 1, preemptions in every preempting run."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    from paddle_tpu_torch.serving import ServingEngine

    tiny = tiny_llama_config()
    cpu = LlamaForCausalLM(tiny, device="cpu", seed=1)
    card = copy.deepcopy(cpu).to(torch.device("cuda"))

    def prompt(n, seed):
        return np.random.RandomState(seed).randint(0, 256, n).astype(
            np.int32)

    sat_prompts = [prompt(12, 0), prompt(10, 1), prompt(14, 2),
                   prompt(9, 3)]
    sys_p = prompt(20, 4)
    mixed_prompts = [prompt(n, 10 + n) for n in (5, 9, 17, 3, 30, 11)] + [
        np.concatenate([sys_p, prompt(n, 20 + n)]) for n in (4, 13)]
    cases = []
    for mode, extra in (("swap", {"host_blocks": 16}), ("recompute", {})):
        for chunk in ({}, {"chunked": True, "prefill_chunk": 8}):
            cases.append((f"{mode}{' chunked' if chunk else ''}",
                          dict(num_slots=4, prefill_batch=2, block_len=8,
                               num_blocks=13, preempt=mode, **extra,
                               **chunk), "saturate"))
    cases.append(("mixed", dict(num_slots=2, block_len=16,
                                kv_cache_dtype="mixed"), "mixed"))
    for label, kw, traffic in cases:
        res = []
        for m, dev in ((card, "cuda"), (cpu, "cpu")):
            eng = ServingEngine(m, max_length=64, paged=True, device=dev,
                                **kw)
            if traffic == "saturate":
                outs = saturate(eng, sat_prompts, new_tokens=12,
                                steps=6 if "chunked" in kw else 3)
            else:
                rids = [eng.submit(p, max_new_tokens=8)
                        for p in mixed_prompts]
                out = dict(eng.drain())
                outs = [out[r] for r in rids]
            res.append((outs, eng.preempt_decisions, eng))
        (c_out, c_dec, c_eng), (p_out, p_dec, p_eng) = res
        m = c_eng.metrics()
        line = {"phase": "model_tiny_f32_tiers", "engine": label,
                "identical_card_vs_cpu": c_out == p_out,
                "decisions_identical": c_dec == p_dec,
                "decisions": len(c_dec),
                **graph_fields(c_eng, p_eng)}
        if label == "mixed":
            line["quantized_blocks"] = m["kv_cache"]["quantized_blocks"]
        emit(line)
        what = f"tiny f32 {label} engine"
        check(c_out == p_out,
              f"{what} differs card vs cpu: {c_out} vs {p_out}")
        check(c_dec == p_dec, f"{what}: preemption decisions differ card "
              f"vs cpu: {c_dec} vs {p_dec}")
        check(label == "mixed" or len(c_dec) > 0, f"{what}: no preemption")
        check(label != "mixed" or line["quantized_blocks"] > 0,
              f"{what}: nothing demoted")
        check_graphed(c_eng, what, p_eng)


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


def grad_gate(torch, model, make_f32, loss_of, phase: str, fields,
              post=None):
    """Gate (a) of the training phases: step-1 gradients of
    ``loss_of(model)`` on the kernel path and on the plain path
    (``reference_mode()``), each against the float32 truth (``make_f32()``:
    the same weights in float32, on the plain path; built first and freed
    before the bf16 paths run).  The kernel path's relative L2 error,
    summed over every tensor, must be within 1.2x the plain path's, and
    tensor by tensor within 1.2x + GRAD_TENSOR_FLOOR, so a wrong dq or dk
    / dv of one projection cannot hide under the embeddings' share of the
    sum.  A one-element tensor (one sum over the batch) is held at
    GRAD_SCALAR_TOL instead.  ``post`` (the list of gradients -> a list)
    is applied to every path's gradients first (a loss scaler's unscale).
    Emits a ``phase`` line (``fields`` first)."""
    from paddle_tpu_torch.ops._dispatch import reference_mode

    def grads(m):
        loss = loss_of(m)
        gs = torch.autograd.grad(loss, list(m.parameters()))
        return float(loss.detach()), (post(gs) if post else gs)

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


def f32_grad_gate(torch, model, loss_of, phase: str, fields):
    """Gate (a) of a float32 training phase, qwen2_vl_f32's gate (c): the
    step-1 loss and gradients of ``loss_of(model)``, kernel path against
    the plain path (``reference_mode()``) on the card -- the loss within
    rtol 1e-5 and every tensor's gradient within F32_GRAD_TOL of its largest
    element (the float32 copy :func:`grad_gate` measures both against is
    the model itself).  Emits a ``phase`` line (``fields`` first)."""
    from paddle_tpu_torch.ops._dispatch import reference_mode

    def grads():
        loss = loss_of(model)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters()))
    loss_k, g_k = grads()
    with reference_mode():
        loss_p, g_p = grads()
    rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(g_k, g_p)]
    finite = all(bool(g.isfinite().all()) for g in g_k)
    del g_k, g_p
    torch.cuda.empty_cache()
    names = [n for n, _ in model.named_parameters()]
    worst = max(range(len(rel)), key=rel.__getitem__)
    line = {"loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "max_grad_diff_over_tensor_max": rel[worst],
            "worst_tensor": names[worst], "tol": F32_GRAD_TOL,
            "finite": finite}
    emit({"phase": phase, **fields, **line})
    check(finite and line["loss_rel_diff"] <= 1e-5,
          f"{phase}: step-1 loss {loss_k} against the plain path's "
          f"{loss_p}")
    check(rel[worst] <= F32_GRAD_TOL,
          f"{phase}: gradient of {names[worst]} differs from the plain "
          f"path's by {rel[worst]} of its largest element")


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


def train_llama(torch, kernels, cfg, phase: str, fields, entries,
                profile: bool = False, steps: int = TRAIN_STEPS):
    """Gates (a)-(c) of a Llama training phase on the card at ``cfg``
    (``recompute=True``), seeded weights, packed TRAIN_ROWS x TRAIN_SEQ
    batches in TRAIN_ACCUM micro-batches, AdamW (lr 3e-4 after a 2-step
    warmup, beta2 0.95, eps 1e-5, weight decay 0.1, clip 1.0), ``steps``
    steps: (a) step-1 gradients of one micro-batch, the kernel path within
    1.2x the plain path's error against a float32 copy, summed and tensor
    by tensor (:func:`grad_gate`, the ``<phase>_grads`` line; a float32
    ``cfg`` is its own float32 copy: :func:`f32_grad_gate`); (b) every
    loss finite, the last below the first; (c) launches a step K2 = 2 x
    TRAIN_ACCUM x layers (recompute runs each forward twice), K5 = K6 =
    TRAIN_ACCUM x layers, every one at ``cfg.head_dim`` (by shape),
    RMSNorm launched, no plain route.  The ``phase`` line (``fields``
    first) reports step ms (median of steps 2..), tokens/s, the
    model-FLOPs share of 989 TFLOP/s (6 x every product's weight a token
    -- a tied embedding table is the head's weight, an untied one only a
    lookup -- plus the visible pairs' attention), optimizer state bytes,
    peak memory; ``entries`` (K5's, K6's, and K2's if a third) take the
    launches in ``kernels``; ``profile`` adds :func:`profile_step`."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    fields = dict(fields, layers=layers, head_dim=cfg.head_dim,
                  params=n_params)
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

    gate_fields = dict(fields, init_s=round(init_s, 3),
                       micro_batch=list(micro["input_ids"].shape),
                       documents=len(torch_counts(micro["segment_ids"])))
    if cfg.dtype == "float32":
        f32_grad_gate(torch, model, lambda m: m.compute_loss(**micro),
                      phase + "_grads", gate_fields)
    else:
        grad_gate(torch, model, llama32, lambda m: m.compute_loss(**micro),
                  phase + "_grads", gate_fields)

    # (b) + (c): ``steps`` steps on the packed batch, every launch and
    # route counter reset just before and read just after
    opt = AdamW(lr.LinearWarmup(3e-4, 2), beta2=0.95, epsilon=1e-5,
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    step = build_train_step(model, opt, grad_accum_steps=TRAIN_ACCUM)
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    losses, step_ms = [], []
    torch.cuda.synchronize()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))      # float() synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    shapes = ops.shape_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    state_bytes = sum(t.numel() * t.element_size()
                      for k, v in opt.state_dict().items() if k != "step"
                      for t in v.values())
    tokens = TRAIN_ROWS * TRAIN_SEQ
    pairs = causal_pairs(batch["segment_ids"], TRAIN_ROWS, TRAIN_SEQ)
    matmul_params = n_params - sum(p.numel() for n, p in
                                   model.named_parameters()
                                   if n.endswith("norm.weight"))
    if not cfg.tie_word_embeddings:
        matmul_params -= cfg.vocab_size * cfg.hidden_size
    model_flops = (6 * matmul_params * tokens
                   + 12 * cfg.head_dim * cfg.num_attention_heads * pairs
                   * layers)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    per_step = {"flash_attention_fwd": 2 * TRAIN_ACCUM * layers,
                "flash_attention_bwd_dq": TRAIN_ACCUM * layers,
                "flash_attention_bwd_dkv": TRAIN_ACCUM * layers}
    by_dim = {name: {str(key[1]): n for key, n in shapes.items()
                     if key[0] == name} for name in per_step}
    emit({"phase": phase, **fields, "recompute": True,
          "batch": [TRAIN_ROWS, TRAIN_SEQ], "grad_accum_steps": TRAIN_ACCUM,
          "documents": len(torch_counts(batch["segment_ids"])),
          "optimizer": "AdamW(LinearWarmup(3e-4, 2), beta2=0.95, eps=1e-5, "
                       "wd=0.1, ClipGradByGlobalNorm(1.0))",
          "losses": losses, "step_ms": step_ms, "step_ms_median": steady,
          "tokens_per_s": tokens / (steady / 1e3),
          "model_flops_per_step": model_flops,
          "model_flops_share_of_989T": model_flops / (steady / 1e3)
          / BF16_FLOPS,
          **({"model_flops_share_of_67T": model_flops / (steady / 1e3)
              / F32_FLOPS} if cfg.dtype == "float32" else {}),
          "optimizer_state_bytes": state_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_head_dim": by_dim,
          "routes": routes})
    check(all(math.isfinite(x) for x in losses), f"{phase}: losses {losses}")
    check(losses[-1] < losses[0],
          f"{phase} did not lower the loss: {losses}")
    for name, n in per_step.items():
        check(launches[name] == n * steps
              and by_dim[name] == {str(cfg.head_dim): n * steps},
              f"{phase}: {name} launched {launches[name]} times in "
              f"{steps} steps ({by_dim[name]} by head_dim), expected "
              f"{n} a step, every one at head_dim {cfg.head_dim}")
    check(launches["rms_norm"] > 0, "RMSNorm kernel not launched")
    plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
    check(not plain, f"{phase}: plain routes taken on the card: {plain}")
    for entry, name in zip(entries, TRAIN_KERNELS + ("flash_attention_fwd",)):
        kernels[entry]["launches"] = launches[name]
    if profile:
        profile_step(torch, step, opt, batch, "profile_" + phase)
    del step, opt, model, batch, micro
    gc.collect()
    torch.cuda.empty_cache()


def phase_training(torch, kernels, profile: bool = False):
    """Phase 5: the single-GPU train step at the Llama-3-8B width, cut to
    TRAIN_LAYERS layers (:func:`train_llama`), then (d) the tiny float32
    model on the card against the CPU."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama3_8b_config,
                                         tiny_llama_config)

    dev = torch.device("cuda")
    cfg = llama3_8b_config(num_hidden_layers=TRAIN_LAYERS, recompute=True)
    train_llama(torch, kernels, cfg, "training", {"config": "llama3_8b"},
                TRAIN_KERNELS, profile)

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
    from paddle_tpu_torch.models import Qwen2VLConfig, tiny_qwen2_vl_config
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
        return qwen_first_decode(torch, mod, ids, pix, tok)

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
    want, want_shapes = qwen_generation_want(cfg, len(m.cross))
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


# qwen2_vl_f32 / serving_f32: the kernel path against the plain path on the
# card, both float32, differing only in sum order (the kernels sum K / V
# tiles and splits in their own order): logits within 1e-4 of the largest
# logit, the step-1 loss at rtol 1e-5 and each gradient tensor within 1e-4
# of its largest element; a wrong tile, mask or merge is O(1)
F32_LOGIT_TOL = 1e-4
F32_GRAD_TOL = 1e-4


def qwen_generation_want(cfg, n_cross):
    """Launches of one ``generate`` call of QWEN_NEW tokens over
    QWEN_BATCH images and QWEN_PROMPT-token prompts, and K2's by (name,
    head_dim, Sq, Skv, causal): the tower's blocks, the causal prefill, the
    cross layers at the prefill and at every decode step, K1 a decoder
    layer a decode step, K3 two a layer, one a cross layer and the final
    norm a pass."""
    layers = cfg.num_hidden_layers
    want = {"flash_attention_fwd": cfg.vision_layers + layers
            + n_cross * QWEN_NEW,
            "decode_attention": layers * (QWEN_NEW - 1),
            "rms_norm": (2 * layers + n_cross + 1) * QWEN_NEW}
    shapes = {
        ("flash_attention_fwd", 64, QWEN_PATCHES, QWEN_PATCHES, False):
            cfg.vision_layers,
        ("flash_attention_fwd", 128, QWEN_PROMPT, QWEN_PROMPT, True): layers,
        ("flash_attention_fwd", 128, QWEN_PROMPT, QWEN_PATCHES, False):
            n_cross,
        ("flash_attention_fwd", 128, 1, QWEN_PATCHES, False):
            n_cross * (QWEN_NEW - 1)}
    return want, shapes


def logit_gate(got, want):
    """Kernel-path logits (a list) against the plain path's: the largest
    difference, the largest plain logit, the tolerance F32_LOGIT_TOL x
    that, finiteness."""
    diff = max(max_err(g, w) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return {"max_logit_diff_kernel_vs_plain": diff, "max_abs_logit": scale,
            "tol": F32_LOGIT_TOL * scale,
            "finite": all(bool(g.isfinite().all()) for g in got)}


def int8_gate(got, want, truth):
    """A session against its float32-cache truth (an int8 cache's, or a
    bf16 model's against a float32 copy): the kernel path's and the plain
    path's largest logit error against ``truth``, the tolerance 1.2x the
    plain path's."""
    err_k = max(max_err(g, t) for g, t in zip(got, truth))
    err_p = max(max_err(w, t) for w, t in zip(want, truth))
    return {"max_logit_err_kernel_vs_f32_cache": err_k,
            "max_logit_err_plain_vs_f32_cache": err_p,
            "tol_kernel_vs_f32_cache": 1.2 * err_p}


def check_logit_gate(g, what):
    """:func:`logit_gate`'s gate, or for an int8 cache :func:`int8_gate`'s
    (the kernel-vs-plain difference is then reported, not gated)."""
    check(g["finite"], f"{what}: logits are not finite")
    if "tol_kernel_vs_f32_cache" in g:
        check(g["max_logit_err_kernel_vs_f32_cache"]
              <= g["tol_kernel_vs_f32_cache"],
              f"{what}: int8 kernel path "
              f"{g['max_logit_err_kernel_vs_f32_cache']} from the float32 "
              f"cache's logits, the plain path "
              f"{g['max_logit_err_plain_vs_f32_cache']}")
        return
    check(g["max_logit_diff_kernel_vs_plain"] <= g["tol"],
          f"{what}: kernel path {g['max_logit_diff_kernel_vs_plain']} from "
          f"the plain path (tolerance {g['tol']})")


def qwen_first_decode(torch, mod, ids, pix, tok):
    """Logits of greedy generation's first decode step: the prompt at
    pos 0 over a fresh cache, then ``tok`` at per-row position
    QWEN_PROMPT (K1 on the card)."""
    from paddle_tpu_torch.models import init_kv_cache
    b = ids.shape[0]
    vision = mod.visual(pix)
    cache = init_kv_cache(mod.config, b, QWEN_PROMPT + QWEN_NEW,
                          dtype=mod.dtype, device=ids.device)
    cache = mod.decode_step(ids, cache, 0, vision)[1]
    pos = torch.full((b,), QWEN_PROMPT, dtype=torch.int32, device=ids.device)
    return mod.decode_step(tok, cache, pos, vision)[0][:, -1].float()


def phase_qwen2_vl_f32(torch, kernels, card):
    """Qwen2-VL exactly as the reference defines it (``Qwen2VLConfig()``:
    float32; the decoder 4 layers of 8 heads of 128, the tower 2 blocks of
    4 heads of 64, 256 patches; 127.4 M parameters), seeded weights with
    the cross gates at 0.5.  Gates: (a) greedy and beam-4 ``generate`` of
    QWEN_NEW tokens, each key built once, graphed and equal bit for bit to
    its eager twin, launches exact by shape (K2 at f32 D 128 causal and
    cross, at D 64 the tower; K1 at f32 D 128), no plain route; (b) the
    forward logits and the first decode step's, kernel path against the
    plain path on the card, within F32_LOGIT_TOL of the largest logit;
    (c) one train step's loss (rtol 1e-5) and gradients (each tensor
    within F32_GRAD_TOL of its largest element) against the plain path,
    K2 / K5 / K6 by shape; then ``build_train_step`` with AdamW (lr 1e-4,
    weight decay 0.01), QWEN_TRAIN_STEPS steps: losses finite, launches
    by shape a step, step ms and peak memory."""
    import numpy as np
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import Qwen2VLConfig
    from paddle_tpu_torch.ops import (_dispatch, launch_counts,
                                      reset_launch_counts, shape_counts)
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.optimizer import AdamW

    dev = torch.device("cuda")
    cfg = Qwen2VLConfig()
    check(cfg.dtype == "float32" and cfg.head_dim == 128,
          f"Qwen2VLConfig() is {cfg.dtype} at head_dim {cfg.head_dim}")
    m = _qwen_model(torch, cfg, dev)
    m.eval()
    n_params = sum(p.numel() for p in m.parameters())
    ids_np, pix_np = qwen_inputs(torch, cfg, QWEN_BATCH, QWEN_PROMPT, 16)
    ids, pix = (torch.from_numpy(a).to(dev) for a in (ids_np, pix_np))

    # (a) greedy and beam search, graphed beside the eager twin
    n_cross = len(m.cross)
    want, want_shapes = qwen_generation_want(cfg, n_cross)
    runs = {}
    for name, kw in (("greedy", {}), ("beam", {"num_beams": 4})):
        r, shapes, _, _ = graphed_and_twin(
            torch, m, lambda kw=kw: m.generate(ids, pix,
                                               max_new_tokens=QWEN_NEW, **kw),
            f"qwen2_vl_f32 {name}", want, QWEN_NEW, want_shapes)
        r["k2_by_shape"] = {"/".join(map(str, k[1:])): n
                            for k, n in shapes.items()}
        r.pop("routes")
        runs[name] = r
    torch.cuda.reset_peak_memory_stats()
    generate_peak = None
    with torch.no_grad():
        m.generate(ids, pix, max_new_tokens=QWEN_NEW)
        generate_peak = torch.cuda.max_memory_allocated() / 1e9

    # (b) logits, kernel path against the plain path
    with torch.no_grad():
        got = m(ids, pix).float()
        tok = got[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        got_d = qwen_first_decode(torch, m, ids, pix, tok)
        with reference_mode():
            plain = m(ids, pix).float()
            plain_d = qwen_first_decode(torch, m, ids, pix, tok)
    gates = {"forward": logit_gate([got], [plain]),
             "first_decode_step": logit_gate([got_d], [plain_d])}
    del got, plain, got_d, plain_d

    # (c) one step's loss and gradients, kernel path against plain path
    m.train()
    micro = qwen_batch(torch, cfg, QWEN_BATCH, QWEN_PROMPT, 100, dev)
    names = [n for n, _ in m.named_parameters()]

    def grads():
        loss = m.compute_loss(**micro)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(m.parameters()))
    reset_launch_counts()
    _dispatch.reset_kernel_paths()
    loss_k, g_k = grads()
    torch.cuda.synchronize()
    grad_shapes = shape_counts()
    grad_routes = {f"{op}/{path}": n for (op, path), n in
                   _dispatch.kernel_paths.items()}
    with reference_mode():
        loss_p, g_p = grads()
    rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(g_k, g_p)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    grad_gate_line = {
        "loss_kernel": loss_k, "loss_plain": loss_p,
        "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
        "max_grad_diff_over_tensor_max": rel[worst],
        "worst_tensor": names[worst], "tol": F32_GRAD_TOL,
        "one_element_tensors": {n: r for n, r, p in zip(
            names, rel, m.parameters()) if p.numel() == 1},
        "finite": all(bool(g.isfinite().all()) for g in g_k)}
    del g_k, g_p
    layers = cfg.num_hidden_layers
    per_step = {(64, QWEN_PATCHES, QWEN_PATCHES, False): cfg.vision_layers,
                (128, QWEN_PROMPT, QWEN_PROMPT, True): layers,
                (128, QWEN_PROMPT, QWEN_PATCHES, False): n_cross}
    want_train = {(name, *key): n for name in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv") for key, n in per_step.items()}

    # build_train_step with the reference's AdamW
    opt = AdamW(QWEN_TRAIN_LR, weight_decay=0.01)
    step = build_train_step(m, opt)
    batches = [qwen_batch(torch, cfg, QWEN_BATCH, QWEN_PROMPT, 200 + i, dev)
               for i in range(QWEN_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _dispatch.reset_kernel_paths()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_shapes = shape_counts()
    train_launches = {k: n for k, n in launch_counts().items() if n}
    train_routes = {f"{op}/{path}": n for (op, path), n in
                    _dispatch.kernel_paths.items()}
    p50 = float(np.median(step_ms[1:]))
    greedy = runs["greedy"]
    emit({"phase": "qwen2_vl_f32", "card": card,
          "config": dataclasses.asdict(cfg), "params": n_params,
          "batch": QWEN_BATCH, "prompt": QWEN_PROMPT, "new_tokens": QWEN_NEW,
          **runs, "generate_peak_allocated_gb": generate_peak,
          "logits": gates, "train_grads": grad_gate_line,
          "grad_launches_by_shape": {"/".join(map(str, k)): n
                                     for k, n in grad_shapes.items()},
          "optimizer": f"AdamW({QWEN_TRAIN_LR}, weight_decay=0.01)",
          "losses": losses, "step_ms": step_ms,
          "step_ms_p50_after_first": p50,
          "train_tokens_per_s": QWEN_BATCH * QWEN_PROMPT / (p50 / 1e3),
          "train_launches": train_launches, "train_routes": train_routes,
          "train_peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "tokens_per_s": greedy["tokens_per_s"]})
    for tag, g in gates.items():
        check_logit_gate(g, f"qwen2_vl_f32 {tag}")
    gl = grad_gate_line
    check(gl["finite"] and gl["loss_rel_diff"] <= 1e-5,
          f"qwen2_vl_f32: step-1 loss {loss_k} against the plain path's "
          f"{loss_p}")
    check(gl["max_grad_diff_over_tensor_max"] <= F32_GRAD_TOL,
          f"qwen2_vl_f32: gradient of {gl['worst_tensor']} differs from the "
          f"plain path's by {gl['max_grad_diff_over_tensor_max']} of its "
          f"largest element")
    check(grad_shapes == want_train,
          f"qwen2_vl_f32: a step's launches by shape {grad_shapes}, "
          f"expected {want_train}")
    check(not any(k.endswith("/plain") for k in grad_routes),
          f"qwen2_vl_f32: a plain route in the train step {grad_routes}")
    check(all(math.isfinite(x) for x in losses),
          f"qwen2_vl_f32 losses {losses}")
    check(train_shapes == {k: n * QWEN_TRAIN_STEPS
                           for k, n in want_train.items()},
          f"qwen2_vl_f32 train: launches by shape {train_shapes}")
    check(not any(k.endswith("/plain") for k in train_routes),
          f"qwen2_vl_f32 train: a plain route {train_routes}")
    for name in TRAIN_KERNELS:
        kernels[name + F32_D128]["launches"] = sum(
            n for k, n in train_shapes.items()
            if k[0] == name and k[1] == 128)
    del step, opt, m, batches, micro
    gc.collect()
    torch.cuda.empty_cache()


# serving_f32: LlamaConfig() as it stands (float32, 32 layers of 32 heads of
# 128, vocab 32000), 8 slots of F32_L positions; the engines, one after
# another: (line label, engine options, attention kernels and their units)
F32_ENGINES = (
    ("contiguous", dict(),
     {"decode_attention": ("tick",), "flash_attention_fwd": ("wave",)}),
    ("paged", dict(paged=True, block_len=128),
     {"decode_attention_paged": ("tick",),
      "flash_attention_fwd_paged": ("wave",)}),
    ("int8_paged", dict(paged=True, block_len=128, kv_cache_dtype="int8"),
     {"decode_attention_paged_int8": ("tick",),
      "flash_attention_fwd_paged_int8": ("wave",)}),
    ("int8_contiguous", dict(kv_cache_dtype="int8"),
     {"decode_attention_int8": ("tick",), "flash_attention_fwd": ("wave",)}))
F32_NEW_TOKENS = 16


def f32_serving_prompts(vocab: int):
    """8 requests of 5..1500 prompt tokens: 4 open with one shared
    512-token system prompt (4 blocks of 128), 4 are unique; the kinds
    alternate in arrival order."""
    import numpy as np
    rng = np.random.RandomState(17)
    system = rng.randint(0, vocab, 512).astype(np.int32)
    prompts = []
    for n_suf, n_uni in zip((5, 300, 37, 900), (5, 100, 700, 1500)):
        prompts.append(np.concatenate(
            [system, rng.randint(0, vocab, n_suf).astype(np.int32)]))
        prompts.append(rng.randint(0, vocab, n_uni).astype(np.int32))
    return prompts


def f32_forced_logits(torch, m, layout, seed=0, int8=None):
    """Teacher-forced logits of a 2-row session in ``layout`` (an
    F32_ENGINES label): contiguous (a 64-token prompt at pos 0 into a
    256-position cache, int8: 128-token granules, then 4 forced decode
    steps at per-row positions) or paged (a 256-token prefix into
    scattered 128-token blocks, a 64-token suffix prefill at per-row pos
    [128, 256] and 4 forced decode steps, all through the block tables).
    ``int8`` (default: the layout's) picks the int8 cache.  Returns (the
    logits of each step, the cache)."""
    import numpy as np
    from paddle_tpu_torch.models import init_kv_cache
    from paddle_tpu_torch.serving.kv_cache import init_paged_kv_cache
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    vocab, b = m.config.vocab_size, 2

    def ids(n):
        return torch.from_numpy(rng.randint(0, vocab, (b, n)).astype(
            np.int32)).to(dev)
    if int8 is None:
        int8 = layout.startswith("int8")
    if layout.endswith("paged"):
        tables = torch.tensor([[6, 2, 0, 0], [3, 8, 5, 0]], dtype=torch.int32,
                              device=dev)
        cache = init_paged_kv_cache(m.config, 10, 128, quantized=int8,
                                    device=dev)
        pos = torch.tensor([128, 256], dtype=torch.int32, device=dev)
        steps = [(ids(256), 0), (ids(64), pos)]
        pos = pos + 64
        kw = {"block_tables": tables}
    else:
        cache = init_kv_cache(m.config, b, 256, quantized=int8, device=dev)
        steps = [(ids(64), 0)]
        pos = torch.full((b,), 64, dtype=torch.int32, device=dev)
        kw = {}
    steps += [(ids(1), pos + t) for t in range(4)]
    outs = []
    with torch.no_grad():
        for x, p in steps:
            logits, cache = m.decode_step(x, cache, p, **kw)
            outs.append(logits.float())
    torch.cuda.synchronize()
    return outs, cache


def int8_flips(torch, a, b):
    """Int8 payload elements of two caches that differ, by layer."""
    return [int((x != y).sum()) for x, y in zip(a["kv"], b["kv"])]


def f32_session_gate(torch, model, label):
    """A float32 model's teacher-forced session in ``label``'s layout
    (:func:`f32_forced_logits`), kernel path against the plain path on the
    card: :func:`logit_gate`, and for an int8 cache :func:`int8_gate`
    against the plain path on a float32 cache."""
    from paddle_tpu_torch.ops._dispatch import reference_mode
    got, got_cache = f32_forced_logits(torch, model, label)
    with reference_mode():
        want, want_cache = f32_forced_logits(torch, model, label)
    gate = logit_gate(got, want)
    if label.startswith("int8"):
        # an int8 cache rounds each K / V element to its block's grid: the
        # two paths' float32 sum orders (RMSNorm's from layer 0 on,
        # attention's from layer 1) put some elements on the other side of
        # a rounding edge, a whole quantum apart (paged: a block whose
        # running-max scale moves is requantized whole), so the int8 paths
        # are held, as phase 3's model_int8 holds its, to 1.2x the plain
        # path's distance from the float32 cache
        with reference_mode():
            truth, _ = f32_forced_logits(torch, model, label, int8=False)
        gate = dict(gate, int8_payload_differences_by_layer=int8_flips(
            torch, got_cache, want_cache), **int8_gate(got, want, truth))
    return gate


def phase_serving_f32(torch, kernels, card, profile=False):
    """``LlamaConfig()`` as it stands (float32, hidden 4096, 32 layers of
    32 / 32 heads of 128, vocab 32000; 26.9 GB of seeded weights), served
    by four engines built and freed one after another -- contiguous,
    paged with the prefix cache, int8-KV paged and int8-KV contiguous
    (8 slots of F32_L positions, prefill_batch 4) -- on 8 requests of
    5..1500 prompt tokens (4 sharing a 512-token system prompt),
    F32_NEW_TOKENS new tokens each.  Gates per engine: graphed,
    ``step_traces`` 1, one replay a tick and a wave; tokens, launches and
    routes equal to its eager twin's; the decode kernel 32 a tick and the
    wave kernel 32 a wave, no other attention kernel, no plain route;
    paged: prefix hits; teacher-forced logits of its layout within
    F32_LOGIT_TOL of the largest logit of the plain path on the card.
    Reported, not gated: greedy tokens equal to the plain path's (an eager
    engine under ``reference_mode()``; random weights leave near-ties that
    float32 sum order may flip), tok/s, TTFT, TPOT, peak memory.
    ``profile``: a ``profile_serving_f32`` line, :func:`profile_window`
    over 5 graphed ticks of the contiguous engine."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops._dispatch import reference_mode
    from paddle_tpu_torch.serving import disable_graphs

    dev = torch.device("cuda")
    cfg = LlamaConfig()
    check(cfg.dtype == "float32" and cfg.head_dim == 128,
          f"LlamaConfig() is {cfg.dtype} at head_dim {cfg.head_dim}")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = f32_serving_prompts(cfg.vocab_size)
    engine_kw = dict(num_slots=8, max_length=F32_L, prefill_batch=4)
    for label, kw, attention in F32_ENGINES:
        kw = dict(engine_kw, **kw)
        run = _serve_8b(torch, model, prompts, new_tokens=F32_NEW_TOKENS,
                        **kw)
        twin = eager_twin(torch, model, prompts, run,
                          f"serving_f32 {label}",
                          new_tokens=F32_NEW_TOKENS, **kw)
        with disable_graphs(), reference_mode():
            plain = _serve_8b(torch, model, prompts,
                              new_tokens=F32_NEW_TOKENS, **kw)
        gate = f32_session_gate(torch, model, label)
        m, launches, routes = run["metrics"], run["launches"], run["routes"]
        cmp = twin_comparison(run["outs"], plain["outs"])
        emit({"phase": "serving_f32", "engine": label, "card": card,
              "config": "LlamaConfig()", "init_s": round(init_s, 3),
              "requests": len(prompts),
              "prompt_lengths": [int(p.size) for p in prompts],
              "new_tokens": F32_NEW_TOKENS, **serving_fields(run),
              "prefill_waves": m["prefill_waves"],
              "decode_ticks": m["decode_ticks"],
              "cache_bytes": run["cache_bytes"],
              "kv_cache": m.get("kv_cache"), "launches": launches,
              "routes": routes, "eager_twin": twin,
              "teacher_forced_logits": gate,
              "plain_path_tokens": {
                  "tokens_identical": cmp["tokens_identical"],
                  "requests_differing": cmp["requests_differing"],
                  "first_difference": cmp["first_difference"],
                  "tok_per_s": serving_fields(plain)["tok_per_s"]}})
        what = f"serving_f32 {label}"
        check_graph(run, what)
        check_twin(twin, what)
        check_attention_launches(what, launches, routes,
                                 attention_launches(m, attention))
        check_logit_gate(gate, what + " teacher-forced")
        if kw.get("paged"):
            check(m["kv_cache"]["prefix_hit_tokens"] > 0,
                  f"{what}: no prefix hit on the shared prompt")
        for name in attention:
            # K2's entry takes the contiguous engine's waves
            kernels[name + F32_D128].setdefault("launches", launches[name])
        del run, twin, plain
        gc.collect()
        torch.cuda.empty_cache()
    if profile:
        from paddle_tpu_torch.serving import ServingEngine
        eng = ServingEngine(model, device="cuda", **engine_kw)
        emit({**profile_window(torch, eng, prompts, "profile_serving_f32",
                               "graphed"), "card": card})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()


# serving_tinyllama: TinyLlama-1.1B as published
# (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T config.json), not
# cut, in bf16 with seeded random weights: head_dim 64, 8 query heads a KV
# head
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=22, num_attention_heads=32,
                 num_key_value_heads=4, max_position_embeddings=2048,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 tie_word_embeddings=False, dtype="bfloat16")
TL_BLOCK_LEN = 64       # the paged engines' blocks: the shared prompt is 8


def serve_llama(torch, kernels, card, phase, config, widths, head_dim, group,
                suffix, builds, int8_weights=False):
    """A Llama at ``widths`` (LlamaConfig fields, their dtype bfloat16,
    float16 or float32; ``head_dim`` and ``group`` query heads a KV head
    checked), seeded, served by serving_f32's four
    engines built and freed one after another -- contiguous, paged with
    the prefix cache (block_len TL_BLOCK_LEN), int8-KV paged and int8-KV
    contiguous (8 slots of F32_L positions, prefill_batch 4) -- on
    serving_f32's 8 requests, F32_NEW_TOKENS new tokens each; then the
    contiguous chunked engine (256-token chunks on K2-paged over the
    identity view) on the same requests, and greedy ``generate`` at B 4.
    Gates per engine: graphed, ``step_traces`` 1; tokens, launches and
    routes equal to its eager twin's; the decode kernel once a layer a
    tick and the wave kernel once a layer a wave (chunked: K2-paged once
    a layer a chunk), no other attention kernel, no plain route; paged:
    prefix hits; teacher-forced logits of its layout within 1.2x the plain
    path's distance from a float32 copy of the weights on a float32 cache
    (:func:`int8_gate`); a float32 model is its own float32 copy, and is
    held as serving_f32 holds LlamaConfig() (:func:`f32_session_gate`).
    ``generate``: one graphed build, bit-equal to its eager twin, K1 once a
    layer a decode step, K2 once a layer a prefill. ``int8_weights``: then
    one more engine on the model's ``QuantizedForDecode`` (int8 weights,
    int8 KV, paged with the prefix cache: phase 4c's configuration) with the
    same gates (its truth the paged one) and K4 7 a layer + the LM head a
    tick, and greedy ``generate`` on it (K4 the same a decode step).
    Reported: tok/s, TTFT, TPOT, decode-step p50 beside the weights' byte
    bound of a tick, peak memory. ``builds`` take their ``suffix`` entries'
    launches in ``kernels``; every line is a ``phase`` line naming
    ``config``."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         quantize_for_decode)
    from paddle_tpu_torch.ops._dispatch import reference_mode

    dev = torch.device("cuda")
    cfg = LlamaConfig(**widths)
    layers = cfg.num_hidden_layers
    check(cfg.head_dim == head_dim and cfg.num_attention_heads
          // cfg.num_key_value_heads == group,
          f"{config} is at head_dim {cfg.head_dim}, "
          f"{cfg.num_attention_heads // cfg.num_key_value_heads} query "
          f"heads a KV head")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    f32 = cfg.dtype == "float32"
    # a tick reads every weight once: its least time on the card
    weight_bound_ms = (4 if f32 else 2) * n_params / HBM_BYTES_PER_S * 1e3
    if not f32:
        # the float32 truth of the teacher-forced sessions: a float32 copy
        # of the weights through the plain path on a float32 cache
        model32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                                   device=dev)
        with torch.no_grad():
            for p32, p in zip(model32.parameters(), model.parameters()):
                p32.copy_(p)
        with reference_mode():
            truths = {lay: f32_forced_logits(torch, model32, lay,
                                             int8=False)[0]
                      for lay in ("contiguous", "paged")}
        del model32
        gc.collect()
        torch.cuda.empty_cache()

    prompts = f32_serving_prompts(cfg.vocab_size)
    engine_kw = dict(num_slots=8, max_length=F32_L, prefill_batch=4)
    base = {"phase": phase, "card": card, "config": config,
            "dtype": cfg.dtype, "params": n_params,
            "weight_bytes_bound_ms": weight_bound_ms,
            "init_s": round(init_s, 3), "requests": len(prompts),
            "prompt_lengths": [int(p.size) for p in prompts],
            "new_tokens": F32_NEW_TOKENS}
    for label, kw, attention in F32_ENGINES:
        kw = dict(engine_kw, **kw)
        if kw.get("paged"):
            kw["block_len"] = TL_BLOCK_LEN
        what = f"{phase} {label}"
        run = _serve_8b(torch, model, prompts, new_tokens=F32_NEW_TOKENS,
                        **kw)
        twin = eager_twin(torch, model, prompts, run, what,
                          new_tokens=F32_NEW_TOKENS, **kw)
        if f32:
            gate = f32_session_gate(torch, model, label)
        else:
            got, _ = f32_forced_logits(torch, model, label)
            with reference_mode():
                want, _ = f32_forced_logits(torch, model, label)
            gate = dict(logit_gate(got, want), **int8_gate(got, want, truths[
                "paged" if label.endswith("paged") else "contiguous"]))
            del got, want
        m, launches, routes = run["metrics"], run["launches"], run["routes"]
        emit({**base, "engine": label, **serving_fields(run),
              "prefill_waves": m["prefill_waves"],
              "decode_ticks": m["decode_ticks"],
              "cache_bytes": run["cache_bytes"],
              "kv_cache": m.get("kv_cache"), "launches": launches,
              "routes": routes, "eager_twin": twin,
              "teacher_forced_logits": gate})
        check_graph(run, what)
        check_twin(twin, what)
        check_attention_launches(what, launches, routes,
                                 attention_launches(m, attention, layers))
        check_logit_gate(gate, what + " teacher-forced")
        if kw.get("paged"):
            check(m["kv_cache"]["prefix_hit_tokens"] > 0,
                  f"{what}: no prefix hit on the shared prompt")
        for name in attention:
            if name in builds:
                kernels[name + suffix].setdefault("launches", launches[name])
        del run, twin
        gc.collect()
        torch.cuda.empty_cache()

    # the contiguous chunked engine: every chunk on K2-paged over the
    # identity view, every tick's decode rows on K1
    kw = dict(engine_kw, chunked=True, prefill_chunk=256,
              chunk_policy="prefill")
    attention = {"decode_attention": ("ticks",),
                 "flash_attention_fwd_paged": ("mixed",)}
    what = f"{phase} chunked"
    run = _serve_8b(torch, model, prompts, new_tokens=F32_NEW_TOKENS, **kw)
    twin = eager_twin(torch, model, prompts, run, what,
                      new_tokens=F32_NEW_TOKENS, **kw)
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    emit({**base, "engine": "chunked", **serving_fields(run),
          "ticks": m["ticks"], "launches": launches, "routes": routes,
          "eager_twin": twin})
    check_graph(run, what)
    check_twin(twin, what)
    check(m["prefill_waves"] == 0 and m["mixed_ticks"] > 0,
          f"{what}: prefill waves {m['prefill_waves']}, mixed ticks "
          f"{m['mixed_ticks']}")
    check_attention_launches(what, launches, routes,
                             attention_launches(m, attention, layers))
    del run, twin
    gc.collect()
    torch.cuda.empty_cache()

    # greedy generate at B 4: K1 contiguous, one graphed build
    rng = np.random.RandomState(18)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (
        GEN_BATCH, GEN_PROMPT)).astype(np.int32)).to(dev)
    want = {"decode_attention": layers * (GEN_NEW - 1),
            "flash_attention_fwd": layers,
            "rms_norm": (2 * layers + 1) * GEN_NEW}
    shapes = {("flash_attention_fwd", head_dim, GEN_PROMPT, GEN_PROMPT,
               True): layers}
    torch.cuda.reset_peak_memory_stats()
    greedy, _, _, _ = graphed_and_twin(
        torch, model, lambda: model.generate(ids, max_new_tokens=GEN_NEW),
        f"{phase} generate", want, GEN_NEW, want_shapes=shapes)
    greedy.pop("routes")
    emit({**base, "engine": "generate", "batch": GEN_BATCH,
          "prompt": GEN_PROMPT, "generate_new_tokens": GEN_NEW,
          "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2**30,
                                  3), **greedy})
    if not int8_weights:
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return

    # int8 weights (the model's QuantizedForDecode) and int8 KV, paged with
    # the prefix cache: K4 on every projection of a tick and of a wave of
    # up to 256 rows
    qmodel = quantize_for_decode(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    k4_tick = 7 * layers + (0 if cfg.tie_word_embeddings else 1)
    hbm_q, _ = qmodel.hbm_bytes()
    kw = dict(engine_kw, paged=True, block_len=TL_BLOCK_LEN,
              kv_cache_dtype="int8", int8_weights=True)
    attention = {"decode_attention_paged_int8": ("tick",),
                 "flash_attention_fwd_paged_int8": ("wave",)}
    what = f"{phase} int8_weights"
    run = _serve_8b(torch, qmodel, prompts, new_tokens=F32_NEW_TOKENS, **kw)
    twin = eager_twin(torch, qmodel, prompts, run, what,
                      new_tokens=F32_NEW_TOKENS, **kw)
    got, _ = f32_forced_logits(torch, qmodel, "int8_paged")
    with reference_mode():
        want, _ = f32_forced_logits(torch, qmodel, "int8_paged")
    gate = dict(logit_gate(got, want),
                **int8_gate(got, want, truths["paged"]))
    del got, want
    m, launches, routes = run["metrics"], run["launches"], run["routes"]
    emit({**base, "engine": "int8_weights", **serving_fields(run),
          "model_hbm_bytes": hbm_q,
          "int8_weight_bytes_bound_ms": hbm_q / HBM_BYTES_PER_S * 1e3,
          "prefill_waves": m["prefill_waves"],
          "decode_ticks": m["decode_ticks"],
          "wave_keys": run["wave_keys"], "cache_bytes": run["cache_bytes"],
          "kv_cache": m.get("kv_cache"), "launches": launches,
          "routes": routes, "eager_twin": twin,
          "teacher_forced_logits": gate})
    check_graph(run, what)
    check_twin(twin, what)
    check_attention_launches(what, launches, routes,
                             attention_launches(m, attention, layers))
    check(launches["int8_matmul"] >= k4_tick * m["decode_ticks"],
          f"{what}: K4 launched {launches['int8_matmul']} times for "
          f"{m['decode_ticks']} decode ticks")
    check_logit_gate(gate, what + " teacher-forced")
    check(m["kv_cache"]["prefix_hit_tokens"] > 0,
          f"{what}: no prefix hit on the shared prompt")
    if "int8_matmul" in builds:
        kernels["int8_matmul" + suffix].setdefault(
            "launches", launches["int8_matmul"])
    del run, twin
    gc.collect()
    torch.cuda.empty_cache()

    want = {"decode_attention": layers * (GEN_NEW - 1),
            "flash_attention_fwd": layers,
            "rms_norm": (2 * layers + 1) * GEN_NEW,
            "int8_matmul": k4_tick * (GEN_NEW - 1)}
    torch.cuda.reset_peak_memory_stats()
    greedy, _, _, _ = graphed_and_twin(
        torch, qmodel, lambda: qmodel.generate(ids, max_new_tokens=GEN_NEW),
        f"{phase} generate int8_weights", want, GEN_NEW, want_shapes=shapes)
    greedy.pop("routes")
    emit({**base, "engine": "generate_int8_weights", "batch": GEN_BATCH,
          "prompt": GEN_PROMPT, "generate_new_tokens": GEN_NEW,
          "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2**30,
                                  3), **greedy})
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()


def phase_serving_tinyllama(torch, kernels, card):
    """TinyLlama-1.1B's published widths (``TINYLLAMA``: 22 layers of 32 /
    4 heads of 64, hidden 2048, vocab 32000; bf16, 2.2 GB of seeded
    weights) through :func:`serve_llama`: the decode kernel 22 a
    tick, the wave kernel 22 a wave or chunk; launches of the
    ``/bf16_d64`` entries."""
    serve_llama(torch, kernels, card, "serving_tinyllama", "TinyLlama-1.1B",
                TINYLLAMA, 64, 8, BF16_D64, BF16_D64_BUILDS)


def phase_serving_f32_tinyllama(torch, kernels, card):
    """TinyLlama-1.1B's published widths (``TINYLLAMA``, not cut) at
    ``dtype="float32"``, the reference's default dtype (1.1 B parameters,
    4.4 GB of seeded weights) through :func:`serve_llama`: serving_f32's
    four engines, the chunked engine and ``generate``, the decode kernel 22
    a tick, the wave kernel 22 a wave or chunk, all at float32 D 64;
    teacher-forced logits within F32_LOGIT_TOL of the plain path's largest
    (int8 caches as serving_f32 holds them); launches of the ``/f32``
    entries of the K1 family and K2-paged(-int8)."""
    serve_llama(torch, kernels, card, "serving_f32_tinyllama",
                "TinyLlama-1.1B float32", dict(TINYLLAMA, dtype="float32"),
                64, 8, F32, F32_SERVING_BUILDS)


# serving_d256: a Llama at Gemma-2B's published widths (google/gemma-2b
# config.json: hidden 2048, 18 layers, 8 query heads over 1 KV head of
# 256, intermediate 16384, vocab 256000, rope_theta 10000, rms_norm_eps
# 1e-6, tied embeddings), not cut, in bf16 with seeded random weights.
# The Llama architecture throughout: Gemma's GeGLU, (1 + w) RMSNorm and
# sqrt(hidden) embedding scale are not in the reference package.
GEMMA2B_WIDTHS = dict(vocab_size=256000, hidden_size=2048,
                      intermediate_size=16384, num_hidden_layers=18,
                      num_attention_heads=8, num_key_value_heads=1,
                      max_position_embeddings=8192, rms_norm_eps=1e-6,
                      rope_theta=10000.0, tie_word_embeddings=True,
                      dtype="bfloat16")


def phase_serving_d256(torch, kernels, card):
    """A Llama at Gemma-2B's widths (``GEMMA2B_WIDTHS``: 18 layers of 8 / 1
    heads of 256, hidden 2048, vocab 256000, tied embeddings; bf16, 5.0 GB
    of seeded weights) through :func:`serve_llama`: the decode kernel
    18 a tick, the wave kernel 18 a wave or chunk, every one a build above
    head_dim 128; launches of the ``/bf16_d256`` entries."""
    serve_llama(torch, kernels, card, "serving_d256",
                "Llama at Gemma-2B's widths", GEMMA2B_WIDTHS, 256, 8,
                BF16_D256, BF16_D256_BUILDS)


# serving_f16: Llama-2-7B as published (meta-llama/Llama-2-7b-hf
# config.json: hidden 4096, intermediate 11008, 32 layers of 32 / 32 heads
# of 128, vocab 32000, 4096 positions, rms_norm_eps 1e-5, rope_theta 10000,
# untied, "torch_dtype": "float16") -- LlamaConfig(dtype="float16"), not
# cut, with seeded random weights
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, max_position_embeddings=4096,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 tie_word_embeddings=False, dtype="float16")
# what serving_f16 passes LlamaConfig: the dtype alone, the rest its
# defaults
F16_WIDTHS = dict(dtype="float16")


def phase_serving_f16(torch, kernels, card):
    """``LlamaConfig(dtype="float16")``, checked equal to Llama-2-7B's
    published configuration (``LLAMA2_7B``: 32 layers of 32 / 32 heads of
    128, hidden 4096, vocab 32000; 6.74 B parameters, 13.5 GB of seeded
    float16 weights) through :func:`serve_llama`: serving_f32's four
    engines, the chunked engine and ``generate``, then the int8-weight
    engine and its ``generate`` (K4 at float16, 225 a tick); the decode
    kernel 32 a tick, the wave kernel 32 a wave or chunk; launches of the
    ``/f16`` entries."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**F16_WIDTHS)
    published = {k: getattr(cfg, k) for k in LLAMA2_7B}
    check(published == LLAMA2_7B,
          f"LlamaConfig(**{F16_WIDTHS}) is not Llama-2-7B: {published}")
    serve_llama(torch, kernels, card, "serving_f16", "Llama-2-7B",
                F16_WIDTHS, 128, 1, F16, F16_BUILDS, int8_weights=True)


def phase_training_d256(torch, kernels, card):
    """The Llama at Gemma-2B's widths (``GEMMA2B_WIDTHS``: all 18 layers of
    8 / 1 heads of 256, hidden 2048, vocab 256000, tied embeddings; bf16,
    seeded weights) trained as phase 5 trains (:func:`train_llama`):
    K2 = 72, K5 = K6 = 36 launches a step, every one at head_dim 256; the
    ``/bf16_d256`` K5 / K6 entries take its launches."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**GEMMA2B_WIDTHS, recompute=True)
    check(cfg.head_dim == 256 and cfg.tie_word_embeddings,
          f"training_d256 is at head_dim {cfg.head_dim}")
    train_llama(torch, kernels, cfg, "training_d256",
                {"card": card, "config": "Llama at Gemma-2B's widths"},
                BF16_D256_BWD)

# training_f32_d256: the Gemma-2B-wide Llama at float32, all 18 layers.
# Its reckoning on one 80 GB card: 2.51 B parameters x 16 bytes (weights,
# gradients, AdamW's two moments) = 40.2 GB, the tied head's 4096 x 256000
# float32 logits, their log-softmax and their gradient 12.6 GB, the
# gradient accumulation and the recomputed layer's activations a few GB:
# ~57 GB, leaving the 10 GB margin, so the depth is not cut.  Its steps run
# float32 GEMMs without TF32 (~3 s each at ~50 TFLOP/s): 4 of them, where
# the 16-bit phases take TRAIN_STEPS
TRAIN_F32_STEPS = 4


def phase_training_f32_d256(torch, kernels, card):
    """The Llama at Gemma-2B's widths (``GEMMA2B_WIDTHS``: all 18 layers of
    8 / 1 heads of 256, hidden 2048, vocab 256000, tied embeddings) at
    ``dtype="float32"``, the reference's default dtype, trained as phase 5
    trains (:func:`train_llama`) for TRAIN_F32_STEPS steps, with the
    float32 gates (:func:`f32_grad_gate`: the step-1 loss rtol 1e-5 and
    every gradient within F32_GRAD_TOL of its tensor's largest element,
    against the plain path on the card); K2 = 2 x TRAIN_ACCUM x 18, K5 =
    K6 = TRAIN_ACCUM x 18 launches a step, every one at float32 head_dim
    256; the ``/f32`` K2, K5 and K6 entries take its launches."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(**dict(GEMMA2B_WIDTHS, dtype="float32"),
                      recompute=True)
    check(cfg.head_dim == 256 and cfg.dtype == "float32",
          f"training_f32_d256 is {cfg.dtype} at head_dim {cfg.head_dim}")
    train_llama(torch, kernels, cfg, "training_f32_d256",
                {"card": card, "config": "Llama at Gemma-2B's widths, "
                 "float32"}, F32_BWD + ("flash_attention_fwd" + F32,),
                steps=TRAIN_F32_STEPS)


# training_f16: Llama-2-7B's float16 widths (LLAMA2_7B) cut in depth only,
# to 8 of 32 layers: 1.88 B parameters take ~26 GB as float16 weights,
# float32 masters and two float32 moments, plus ~11 GB of float16 and
# float32 gradients; the 32 layers (~108 GB) do not fit one 80 GB card
TRAIN_F16_LAYERS = 8
# gate (d): a loss scale at which the float16 backward overflows (the
# reference's own skip test overflows the same way from 2^40)
OVERFLOW_SCALE = 2.0 ** 40


def scaler_replay(seen, scaler):
    """The loss scaler's states after each step, replayed from the
    found_inf values ``seen`` by the reference's update rule
    (``paddle_tpu/amp/__init__.py`` :183-195), in Python numbers."""
    scale, good, bad, out = scaler._init_scale, 0, 0, []
    for found in seen:
        bad, good = (bad + 1, 0) if found else (0, good + 1)
        if bad >= scaler.decr_every_n_nan_or_inf:
            scale, bad = scale * scaler.decr_ratio, 0
        if good >= scaler.incr_every_n_steps:
            scale, good = scale * scaler.incr_ratio, 0
        out.append((scale, good, bad))
    return out


def phase_training_f16(torch, kernels, card):
    """``LlamaConfig(dtype="float16")`` at Llama-2-7B's published widths
    (``LLAMA2_7B``), cut to TRAIN_F16_LAYERS of 32 layers, ``recompute``,
    trained the reference's float16 way: ``amp.decorate(model, opt,
    level="O2", dtype="float16")`` and an ``amp.GradScaler`` at its
    defaults (2^15) in ``build_train_step``, on phase 5's batches and
    AdamW.  Gates: (a) step-1 gradients of the scaled loss, unscaled as
    the scaler unscales, the kernel path within 1.2x the plain path's
    error against a float32 copy (:func:`grad_gate`); (b) TRAIN_STEPS
    steps: every loss finite, the last below the first, each step's
    found_inf and scale reported, the scaler's states those of its update
    rule replayed from the found_inf values (:func:`scaler_replay`), every
    step taken advancing the optimizer's step counter and its moments (and
    the parameters once the warmup's lr is above 0), every step skipped
    leaving them; (c) K2 = 2 x TRAIN_ACCUM x layers and K5 = K6 =
    TRAIN_ACCUM x layers launches a step, every one at head_dim 128 and
    from the float16 libraries, no plain route; (d) one more step at
    OVERFLOW_SCALE: the float16 backward overflows, the step is skipped
    (parameters, float32 masters, moments and the step counter bit-equal
    to before), the scale halves, the unscaled loss is finite.  The
    ``/f16`` K5 / K6 entries take (c)'s launches."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import _dispatch
    from paddle_tpu_torch.ops.cuda import flash_attention as k2mod
    from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56mod
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    phase = "training_f16"
    cfg = LlamaConfig(**F16_WIDTHS, num_hidden_layers=TRAIN_F16_LAYERS,
                      recompute=True)
    widths = {k: getattr(cfg, k) for k in LLAMA2_7B}
    check(widths == dict(LLAMA2_7B, num_hidden_layers=TRAIN_F16_LAYERS),
          f"{phase} is not Llama-2-7B cut to {TRAIN_F16_LAYERS} layers: "
          f"{widths}")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    opt = AdamW(lr.LinearWarmup(3e-4, 2), beta2=0.95, epsilon=1e-5,
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")

    class RecordingScaler(amp.GradScaler):
        """The scaler at its defaults, keeping the found_inf of each
        update."""

        def __init__(self):
            super().__init__()
            self.seen = []

        def update_state(self, state, found_inf):
            self.seen.append(bool(found_inf))
            return super().update_state(state, found_inf)

    scaler = RecordingScaler()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    fields = {"card": card, "config": "Llama-2-7B", "layers": layers,
              "of_layers": LLAMA2_7B["num_hidden_layers"],
              "head_dim": cfg.head_dim, "params": n_params,
              "dtype": "float16", "amp": "O2",
              "init_loss_scaling": scaler._init_scale}
    check(all(p.dtype == torch.float16 for p in model.parameters())
          and opt._multi_precision, f"{phase}: not an O2 float16 model")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in packed_batch(
        cfg.vocab_size, TRAIN_ROWS, TRAIN_SEQ, seed=5).items()}
    micro = {k: v[:TRAIN_ROWS // TRAIN_ACCUM] for k, v in batch.items()}

    # (a) step-1 gradients of the scaled loss, unscaled as the scaler does
    def llama32():
        m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                               device=dev)
        with torch.no_grad():
            for p32, p in zip(m32.parameters(), model.parameters()):
                p32.copy_(p)
        return m32

    inv = 1.0 / scaler._init_scale
    grad_gate(torch, model, llama32,
              lambda m: scaler.scale(m.compute_loss(**micro)),
              phase + "_grads",
              dict(fields, init_s=round(init_s, 3),
                   micro_batch=list(micro["input_ids"].shape)),
              post=lambda gs: [(g.float() * inv).to(g.dtype) for g in gs])

    # (b) + (c): TRAIN_STEPS steps, the launch and route counters and the
    # libraries' dtypes reset just before and read just after
    step = build_train_step(model, opt, grad_accum_steps=TRAIN_ACCUM,
                            scaler=scaler)
    libs = collections.Counter()

    def counting(mod, name):
        load = mod._lib

        def lib(dtype):
            libs[(name, str(dtype)[6:])] += 1
            return load(dtype)
        return load, lib
    loads = {}
    for mod, name in ((k2mod, "flash_attention_fwd"),
                      (k56mod, "flash_attention_bwd")):
        loads[mod], mod._lib = counting(mod, name)
    probes = {"model.norm.weight": model.model.norm.weight,
              "lm_head": model.lm_head}

    def snapshot():
        st = opt.state_dict() or {}
        return ({k: p.detach()[:8].clone() for k, p in probes.items()},
                {k: st["moment1"][k][:8].clone() for k in probes}
                if st else None, st.get("step", 0))

    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    scaler.seen.clear()
    losses, step_ms, steps = [], [], []
    torch.cuda.synchronize()
    try:
        for i in range(TRAIN_STEPS):
            before = snapshot()
            lr_i = opt.get_lr()
            t0 = time.perf_counter()
            losses.append(float(step(batch)))      # float() synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = snapshot()
            st = scaler._state
            steps.append({
                "loss": losses[-1], "found_inf": scaler.seen[-1],
                "scale": float(st["scale"]),
                "good_steps": int(st["good_steps"]),
                "bad_steps": int(st["bad_steps"]), "lr": lr_i,
                "opt_step": after[2],
                "params_moved": any(not torch.equal(before[0][k],
                                                    after[0][k])
                                    for k in probes),
                "moments_moved": after[1] is not None and (
                    before[1] is None or any(
                        not torch.equal(before[1][k], after[1][k])
                        for k in probes)),
                "step_counter_moved": after[2] == before[2] + 1})
    finally:
        for mod, load in loads.items():
            mod._lib = load
    launches = ops.launch_counts()
    shapes = ops.shape_counts()
    routes = {f"{op}/{path}": n for (op, path), n in
              _dispatch.kernel_paths.items()}
    tokens = TRAIN_ROWS * TRAIN_SEQ
    pairs = causal_pairs(batch["segment_ids"], TRAIN_ROWS, TRAIN_SEQ)
    matmul_params = n_params - sum(p.numel() for n, p in
                                   model.named_parameters()
                                   if n.endswith("norm.weight"))
    matmul_params -= cfg.vocab_size * cfg.hidden_size   # the lookup table
    model_flops = (6 * matmul_params * tokens
                   + 12 * cfg.head_dim * cfg.num_attention_heads * pairs
                   * layers)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    per_step = {"flash_attention_fwd": 2 * TRAIN_ACCUM * layers,
                "flash_attention_bwd_dq": TRAIN_ACCUM * layers,
                "flash_attention_bwd_dkv": TRAIN_ACCUM * layers}
    by_dim = {name: {str(key[1]): n for key, n in shapes.items()
                     if key[0] == name} for name in per_step}
    state_bytes = sum(t.numel() * t.element_size()
                      for k, v in opt.state_dict().items() if k != "step"
                      for t in v.values())
    emit({"phase": phase, **fields, "recompute": True,
          "batch": [TRAIN_ROWS, TRAIN_SEQ], "grad_accum_steps": TRAIN_ACCUM,
          "documents": len(torch_counts(batch["segment_ids"])),
          "optimizer": "AdamW(LinearWarmup(3e-4, 2), beta2=0.95, eps=1e-5, "
                       "wd=0.1, ClipGradByGlobalNorm(1.0)), O2 masters",
          "steps": steps, "losses": losses, "step_ms": step_ms,
          "step_ms_median": steady, "tokens_per_s": tokens / (steady / 1e3),
          "model_flops_per_step": model_flops,
          "model_flops_share_of_989T": model_flops / (steady / 1e3)
          / BF16_FLOPS,
          "optimizer_state_bytes": state_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_head_dim": by_dim,
          "library_dtypes": {f"{n}/{dt}": c for (n, dt), c in libs.items()},
          "routes": routes})
    check(all(math.isfinite(x) for x in losses), f"{phase}: losses {losses}")
    check(losses[-1] < losses[0], f"{phase} did not lower the loss: {losses}")
    want = scaler_replay(scaler.seen, scaler)
    got = [(r["scale"], r["good_steps"], r["bad_steps"]) for r in steps]
    check(got == want, f"{phase}: the scaler's states {got} are not the "
                       f"update rule's {want} from found_inf {scaler.seen}")
    for i, r in enumerate(steps):
        taken = not r["found_inf"]
        ok = (r["step_counter_moved"] == taken
              and r["moments_moved"] == taken
              and r["params_moved"] == (taken and r["lr"] > 0))
        check(ok, f"{phase} step {i + 1}: found_inf {r['found_inf']} but "
                  f"{r}")
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS
              and by_dim[name] == {"128": n * TRAIN_STEPS},
              f"{phase}: {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps ({by_dim[name]} by head_dim), expected "
              f"{n} a step, every one at head_dim 128")
    k2_f16 = libs[("flash_attention_fwd", "float16")]
    k56_f16 = libs[("flash_attention_bwd", "float16")]
    check(k2_f16 == launches["flash_attention_fwd"]
          and k56_f16 == 2 * launches["flash_attention_bwd_dq"]
          and sum(libs.values()) == k2_f16 + k56_f16,
          f"{phase}: launches not all from the float16 libraries: "
          f"{dict(libs)}")
    check(launches["rms_norm"] > 0, "RMSNorm kernel not launched")
    plain = {k: n for k, n in routes.items() if k.endswith("/plain")}
    check(not plain, f"{phase}: plain routes taken on the card: {plain}")
    for entry, name in zip(F16_BWD, TRAIN_KERNELS):
        kernels[entry]["launches"] = launches[name]

    # (d) one step at a scale the float16 backward overflows at
    scaler._state = dict(scaler._state,
                         scale=torch.tensor(OVERFLOW_SCALE))
    params = opt.trainable()
    state = opt.state_dict()
    before = ({k: p.detach().clone() for k, p in params.items()},
              {s_: {k: t.clone() for k, t in state[s_].items()}
               for s_ in ("master", "moment1", "moment2")}, state["step"])
    loss = float(step(batch))
    same = (all(torch.equal(before[0][k], p) for k, p in params.items())
            and all(torch.equal(before[1][s_][k], t)
                    for s_ in before[1] for k, t in state[s_].items())
            and state["step"] == before[2])
    del before
    emit({"phase": phase + "_overflow", "card": card,
          "scale_before": OVERFLOW_SCALE, "found_inf": scaler.seen[-1],
          "scale_after": float(scaler.loss_scaling), "loss": loss,
          "state_bit_equal": same})
    check(scaler.seen[-1] and same
          and float(scaler.loss_scaling) == OVERFLOW_SCALE / 2
          and math.isfinite(loss),
          f"{phase}: the overflowing step was not skipped cleanly: "
          f"found_inf {scaler.seen[-1]}, state bit-equal {same}, scale "
          f"{float(scaler.loss_scaling)}, loss {loss}")
    del step, opt, model, batch, micro, params, state
    gc.collect()
    torch.cuda.empty_cache()


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
    phase_serving_mixed(torch, model, kernels, run4b)
    swap4m = phase_serving_preempt(torch, model)
    phase_observability(run4b, run4c, swap4m)
    phase_serving_router(torch, model)
    phase_serving_multihost(torch, model, card)
    if args.profile:
        phase_profile(torch, model, qmodel)
    phase_generate(torch, model, qmodel, card)
    # the loops' ``m`` is the int8 model too: drop every name of both
    del model, qmodel, m
    for phase in (lambda: phase_serving_f32(torch, kernels, card,
                                            profile=args.profile),
                  lambda: phase_serving_tinyllama(torch, kernels, card),
                  lambda: phase_serving_f32_tinyllama(torch, kernels, card),
                  lambda: phase_serving_d256(torch, kernels, card),
                  lambda: phase_serving_f16(torch, kernels, card),
                  lambda: phase_training_d256(torch, kernels, card),
                  lambda: phase_training_f16(torch, kernels, card),
                  lambda: phase_training_f32_d256(torch, kernels, card),
                  lambda: phase_dit(torch, kernels, card,
                                    profile=args.profile),
                  lambda: phase_dit_train(torch, kernels, card,
                                          profile=args.profile),
                  lambda: phase_qwen2_vl(torch, kernels, card),
                  lambda: phase_qwen2_vl_train(torch, kernels, card),
                  lambda: phase_qwen2_vl_f32(torch, kernels, card),
                  lambda: phase_training(torch, kernels,
                                         profile=args.profile)):
        # what the phases before left on the card (a phase that keeps
        # memory shows here, not as a later phase's out-of-memory)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "memory", "allocated_gb":
              torch.cuda.memory_allocated() / 2**30,
              "reserved_gb": torch.cuda.memory_reserved() / 2**30})
        phase()
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
