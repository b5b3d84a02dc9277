"""The flags this slice of the port reads (mirrors ``paddle_tpu/flags.py``).

Only the serving defaults, the flash-decode chunk size, the train step's
``check_nan_inf``, the build watchdog's action and the observability
layer's flags (the metrics registry's label cap, the span tracer, the
request log, the SLO deadlines, the cost model and predictive admission),
the control plane's (the replica router, the autoscaler, the HTTP
exposition's port) and the multihost plane's (its socket calls,
heartbeats and streaming poll) are kept.  The
JAX package's routing thresholds (``decode_attention_min_len``,
``rms_norm_pallas_min_dim``, the flash block sizes) were measured on a TPU
and do not carry over: the port routes every eligible CUDA tensor to its
kernel.  The serving flags are the engine's defaults.
"""

from __future__ import annotations

from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # flash-decode KV split: the JAX kernel walks a row's cache in chunks
    # of at most this many keys, one grid step each; the CUDA kernel gives
    # each CTA a split of at most this many keys and merges the splits'
    # partials with the LSE algebra (ops/cuda/decode_attention.py).  256
    # was the fastest of 64..4096 on an H100 at B=8, L=4096, ragged depths
    # (chip_smoke.py --profile; PERF.md); the reference's 512 is a TPU
    # DMA-block choice.
    "decode_attention_block_kv": 256,
    # paged KV cache (paddle_tpu/flags.py:150-160): tokens per block, pool
    # size in blocks (0 = num_slots * max_blocks + 1, the contiguous
    # footprint plus the null block)
    "kv_cache_block_len": 128,
    "kv_cache_num_blocks": 0,
    # serving defaults (paddle_tpu/flags.py:150-210); serving_paged_kv
    # selects the paged engine, serving_prefix_cache its prefix trie
    "serving_paged_kv": False,
    "serving_prefix_cache": True,
    "serving_kv_cache_dtype": "bf16",
    "serving_int8_weights": False,
    # chunked prefill (paddle_tpu/flags.py:187-204): serving_chunked_prefill
    # selects the chunked engine; serving_prefill_chunk is the prompt
    # tokens a mixed step carries (num_slots decode tokens plus one chunk
    # of at most this many: static, part of the step's shape);
    # serving_chunk_policy "prefill" runs a pending chunk every tick,
    # "decode" only on alternate ticks while any slot decodes
    "serving_chunked_prefill": False,
    "serving_prefill_chunk": 256,
    "serving_chunk_policy": "prefill",
    # speculative decode (paddle_tpu/flags.py:205-233): serving_spec_decode
    # selects the speculative engine; serving_spec_k is the drafts a slot a
    # tick (the verify step's window is k + 1 tokens: static, part of its
    # shape); serving_spec_ngram the longest n-gram the prompt-lookup
    # drafter matches; serving_spec_drafter the default drafter kind,
    # "ngram" or "model"
    "serving_spec_decode": False,
    "serving_spec_k": 4,
    "serving_spec_ngram": 3,
    "serving_spec_drafter": "ngram",
    # preemption and the host KV tier (paddle_tpu/flags.py:349-368):
    # serving_preempt is what a paged admission blocked on a full pool may
    # do to a running request of lower priority, "off", "swap" (its private
    # blocks to the host tier, restored bit for bit) or "recompute" (its
    # chain freed, re-prefilled through the prefix trie);
    # serving_host_blocks the host tier's capacity in blocks (0: none; at
    # least 1 for "swap"); serving_preempt_after the ticks a waiter must
    # have been blocked before it may preempt a request of its own priority
    "serving_preempt": "off",
    "serving_host_blocks": 0,
    "serving_preempt_after": 2,
    # training (paddle_tpu/flags.py check_nan_inf): the train step raises
    # FloatingPointError when a gradient is not finite
    "check_nan_inf": False,
    # what a tracked site does when it builds its step program past its
    # budget (paddle_tpu/flags.py:315; observability/watchdog.py):
    # "raise", "warn" or "off"
    "retrace_watchdog": "warn",
    # observability (paddle_tpu/flags.py:314-441): observability_spans
    # records host spans into the default SpanTracer (off: span() is a
    # no-op); trace_buffer_events is its ring's capacity;
    # request_log_max_requests the RequestLog's capacity in whole
    # requests; metrics_max_children the label sets a metric family takes
    # before it coalesces new ones into {overflow="true"}
    "observability_spans": True,
    "trace_buffer_events": 100000,
    "request_log_max_requests": 4096,
    "metrics_max_children": 64,
    # per-request deadlines recorded at submit() (0: that deadline off):
    # TTFT from submit, TPOT the mean decode time a token after the first
    "serving_slo_ttft_ms": 0.0,
    "serving_slo_tpot_ms": 0.0,
    # the engine's per-tick roofline cost model (observability/
    # costmodel.py): "on" or "off"; the hardware profile ("auto": "h100"
    # on a CUDA device, "cpu_smoke" elsewhere); the drift band's
    # half-width around the calibrated measured / predicted ratio
    "perf_model": "on",
    "perf_model_profile": "auto",
    "perf_model_tol": 3.0,
    # admission policy: "queue_depth" (admit whenever a slot and blocks
    # are free) or "predictive" (hold a request back while the cost
    # model prices the post-admission tick over the pooled TPOT deadline
    # times serving_admission_slack; predictions times
    # serving_admission_calib are wall ms; a request held
    # serving_admission_max_defer_ticks ticks is admitted anyway, 0 never)
    "serving_admission": "queue_depth",
    "serving_admission_slack": 1.25,
    "serving_admission_calib": 1.0,
    "serving_admission_max_defer_ticks": 64,
    # the single-host control plane (paddle_tpu/flags.py:249-258,
    # :427-440): serving_dp_replicas the ReplicaRouter's default replica
    # count, serving_router_policy its placement policy ("prefix",
    # "least_loaded" or "round_robin"); the ReplicaAutoscaler acts once
    # pressure or slack persisted serving_autoscale_min_ticks observe()
    # ticks, at least serving_autoscale_cooldown ticks after its last
    # action; metrics_port the HTTP exposition's port (0 off, -1 an
    # ephemeral one)
    "serving_dp_replicas": 1,
    "serving_router_policy": "prefix",
    "serving_autoscale_min_ticks": 8,
    "serving_autoscale_cooldown": 16,
    "metrics_port": 0,
    # the multihost serving plane (paddle_tpu/flags.py:447-466): a socket
    # call's timeout, its reconnect attempts and their exponential
    # backoff's base (base * 2**attempt seconds; only idempotent methods
    # are replayed after a broken connection), the plane ticks between
    # heartbeat pings (ticks, not wall time, so loopback replays stay
    # deterministic) and the streaming front end's idle sleep
    "multihost_call_timeout_s": 5.0,
    "multihost_call_retries": 2,
    "multihost_retry_backoff_s": 0.05,
    "multihost_heartbeat_every": 4,
    "multihost_stream_poll_s": 0.002,
}

_values: Dict[str, Any] = dict(_DEFAULTS)


def flag(name: str) -> Any:
    """Current value of ``name`` (KeyError for a flag this slice lacks)."""
    return _values[name]


def set_flags(values: Dict[str, Any]) -> None:
    """Set flags by name; unknown names raise KeyError."""
    for k, v in values.items():
        if k not in _DEFAULTS:
            raise KeyError(f"unknown flag {k!r}")
        _values[k] = v
