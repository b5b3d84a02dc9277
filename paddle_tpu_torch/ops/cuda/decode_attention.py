"""Flash-decode over a contiguous or paged KV cache — kernel K1 of the port
(source: ``paddle_tpu_torch/csrc/decode_attention.cu``).

Replaces ``paddle_tpu/ops/pallas/decode_attention.py::decode_attention_pallas``
(body ``_kernel`` :120), contiguous layout (:func:`decode_attention_cuda`)
and paged layout (:func:`decode_attention_paged_cuda`, K1-paged).  Computes
``out[b, si, h] = softmax_j(q . k_j * scale) . v_j`` over keys
``j <= pos_b + si`` only, GQA grouped (kv head = h // G, K/V never
broadcast), float32 accumulation with an online softmax; a row whose keys
are all masked returns 0.

Bound on the H100: memory — the live K+V bytes over 3.35 TB/s; at s = 1
each key is used for G query rows, ~1 operation per byte.  What the design
does about it: each (row, kv head) walks only its live prefix
``[0, pos_b + s)`` and never reads the dead cache tail, so a tick costs
what the rows' depths need, not ``max_length`` (the reason the TPU kernel
exists, ``decode_attention.py:13-31``).  The TPU kernel walks a row's
chunks in sequence on one core; on Hopper the walk is split across CTAs
(``FLAGS_decode_attention_block_kv`` keys each, a multiple of 8) so a batch
of 8 rows x 8 kv heads still fills 132 SMs, and the splits' (acc, m, l)
partials are merged with the LSE algebra of
``paddle_tpu/ops/ring_attention.py::merge_attention``.

Every build at bfloat16 and float16 — K1 (:func:`decode_attention_cuda`),
K1-int8 (:func:`decode_attention_int8_cuda`), K1-paged
(:func:`decode_attention_paged_cuda`) and K1-paged-int8
(:func:`decode_attention_paged_int8_cuda`), the decode tick of every
16-bit engine, at any head_dim D <= 256 with D % 8 == 0
(``BF16_HEAD_DIMS``; float16 is the same body compiled over float16, a
library of its own, ``_build.VARIANTS``) — runs the Hopper kernel (``decode_mma_kernel<INT8, PAGED, PAD, PD>``): a
CTA takes up to ``MMA_ROWS`` query rows of one (row, kv head) pair and one
split; its ``MMA_WARPS`` warps take the split's ``MMA_SLICE``-key slices
in turn, each through its own cp.async ring in shared memory (16-byte
copies a key row).  The products run on tensor cores transposed,
Sᵀ = K·Qᵀ and Oᵀ += Vᵀ·Pᵀ with the query rows as ``mma.sync.m16n8k16``'s
8 columns, and int8 K/V are converted to 16 bits in registers.  Its ring
rows are ``PD`` = 128 elements wide up to D 128 and 256 wide above (twice
the k steps, and two head-dim elements a merging thread); below PD an
instance of its own (``PAD``: at 128 and 256 the head dim is a constant
the body never tests) zero-fills a row's chunks past D in the same copies
(an int8 row of D % 16 == 8 bytes, only 8-byte aligned, goes in 8-byte
copies) and zeroes q's fragments there, so the pad adds nothing and only
D columns are stored; the bytes read stay D a key.  The splits
of a tile are merged by the last of its CTAs to finish, in split order
(the same bits every run), with int32 counters the wrapper keeps per
(device, stream).  The builds differ only in where a key row lives: the contiguous cache
(B, L, Hkv, D) holds key ``j`` of row ``b`` at its row ``b * L + j``, with no
lookup; the pooled ``(num_blocks, block_len, Hkv, D)`` cache at
``pool[table[b, j // block_len], j % block_len]`` through an int32
``(B, max_blocks)`` block table (the Pallas kernel's block-table
scalar-prefetch mode, ``decode_attention.py:244-256``).  The paged logical
length is ``max_blocks * block_len`` and each row reads only keys below
``min(pos_b + s, max_blocks * block_len, live_len)``, so the table's
null-filled dead tail is never read; ``block_len`` must be a multiple of 8
(a slice's two 8-key groups each lie in one block).

The float32 builds — every head_dim D <= 256 with D % 8 == 0, the same
set (the tiny models' 16, TinyLlama's 64, the reference's float32 default
configurations' 128, ``LlamaConfig()`` and ``Qwen2VLConfig()``'s decoder, a
Gemma-2B-wide Llama's 256) — keep a CUDA-core body in float32 throughout:
each warp walks its own 8-key blocks (4-key above D 128) with its own
online softmax (a lane holds 1, 2, 4 or 8 elements of a row, the least
that covers D in 32 lanes, one vector load a key row; lanes past D load
nothing), and a second small kernel merges the splits.  Every build at
every dtype is held against the plain version on the card
(``chip_smoke.py``); any other pair raises.

The int8 builds (:func:`decode_attention_int8_cuda`, contiguous, and
K1-paged-int8; replacing the Pallas kernel's ``quantized`` mode,
``decode_attention.py:122-128, 160-187``) read int8 K/V — half the bytes —
with one float32 scale per (granule or block, kv head): contiguous scales
(B, n_gran, Hkv) over granules of ``L // n_gran`` positions, paged scales
(num_blocks, Hkv).  An 8-key group lies inside one granule or block (both
multiples of 8, as is the split length), so each group's two scales are
folded as the Pallas body folds them: K's into the score
(``q . k_int8 * scale * k_scale``), V's into the group's probabilities
before they weight V (the same as scaling the P.V product).  Everything
else — live-prefix walk, splits, merge — is the bf16 kernel's.  At
float16 (5 exponent bits) P times a V scale near 1e-4 would be
subnormal, so the float16 build folds each slice's V scales into P
relative to the larger of them and keeps the accumulator in units of
it: the scale itself is applied in float32.

Under CUDA-graph capture (the serving engine's decode step,
``serving/step_graph.py``) everything the host computes for a launch is
fixed at capture and replayed as it was: the split length
(``FLAGS_decode_attention_block_kv``, read at capture: a later change of
the flag does not reach a captured graph) and the split count (from the
static ``L`` or ``max_blocks * block_len``; the decode tick passes no
``live_len``), the grid, the scratch (allocated in the graph's own memory
pool) and the merge counters (an engine-owned buffer, see
:func:`private_counters`).  ``pos`` and the block table are read by the
kernel from device memory, so a replay sees the values its caller copied
into the static buffers.  The first launch of a build sets its shared
memory attributes (``cudaFuncSetAttribute``), which the engine's warm-up
does before the capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import torch

from ... import flags
from . import (BF16_HEAD_DIMS, _build, block_table, check_attention_args,
               check_scales, library, pos_vector, stream_ptr)

NAME = "decode_attention"
# the head dims built for each dtype, one set: bf16 and float16 the Hopper
# body, float32 the CUDA-core body, at every D <= 256 with D % 8 == 0;
# other pairs are ROADMAP B2
HEAD_DIM = dict.fromkeys((torch.bfloat16, torch.float16, torch.float32),
                         BF16_HEAD_DIMS)

# the bf16 builds (decode_mma_kernel): query rows a CTA
# (mma.sync's n8), keys a warp step, warps a CTA (warp w takes slices w,
# w + MMA_WARPS, ... of its split)
MMA_ROWS = 8
MMA_SLICE = 16
MMA_WARPS = 4

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    """The library of ``dtype``'s build (float16: its own)."""
    lib = _build.load(library(NAME, dtype))
    fn = lib.decode_attention
    if fn.argtypes is None:
        # q k v pos out po pml cnt; B S Hq Hkv D L lim split nsplit; scale;
        # dt st
        fn.argtypes = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _I, _P]
        fn.restype = ctypes.c_int
        # q k v pos tbl out po pml cnt; B S Hq Hkv D mb bl lim split nsplit;
        # scale; dt st
        fp = lib.decode_attention_paged
        fp.argtypes = [_P] * 9 + [_I] * 10 + [ctypes.c_float, _I, _P]
        fp.restype = ctypes.c_int
        # q k v k_scale v_scale pos out po pml cnt; B S Hq Hkv D L n_gran
        # lim split nsplit; scale; dt st
        fi = lib.decode_attention_int8
        fi.argtypes = [_P] * 10 + [_I] * 10 + [ctypes.c_float, _I, _P]
        fi.restype = ctypes.c_int
        # q k v k_scale v_scale pos tbl out po pml cnt; B S Hq Hkv D mb bl
        # lim split nsplit; scale; dt st
        fpi = lib.decode_attention_paged_int8
        fpi.argtypes = [_P] * 11 + [_I] * 10 + [ctypes.c_float, _I, _P]
        fpi.restype = ctypes.c_int
        occ = lib.decode_attention_mma_ctas_per_sm
        occ.argtypes = [_I, _I, _I]
        occ.restype = ctypes.c_int
    return lib


def _scratch(q: torch.Tensor, hkv: int, nsplit: int):
    """Split partials: one float32 scratch holding (B*Hkv, nsplit, rows,
    D) partial sums, then (B*Hkv, nsplit, rows, 2) running max /
    normaliser.  Returns (scratch, partial-sum pointer, max/normaliser
    pointer); (None, None, None) for one split.  The caller keeps the
    scratch tensor until the launch is enqueued, so no allocation made
    before it can take the same memory."""
    if nsplit <= 1:
        return None, None, None
    b, s, hq, d = q.shape
    rows = s * (hq // hkv)
    n_o = b * hkv * nsplit * rows * d
    part = torch.empty(n_o + b * hkv * nsplit * rows * 2,
                       dtype=torch.float32, device=q.device)
    return part, part.data_ptr(), part.data_ptr() + 4 * n_o


# (device index, stream handle) -> int32 zeros: the counters of the Hopper
# kernel's in-kernel merge
_counters = {}


@contextlib.contextmanager
def private_counters(store: dict):
    """Launches made while open take their merge counters from ``store``
    (keyed as the process-wide ``_counters``) instead.  A CUDA graph bakes
    in the raw pointer of every counter buffer it was captured with, and
    ``_counter_buffer`` replaces a process-wide buffer (freeing the old
    one) when a later launch needs more counters; so an engine that
    captures its decode step owns its buffers: it warms the step up in
    this context (the buffer is allocated then, outside the graph's
    memory pool), captures in it (the captured launches find the same
    buffer) and keeps ``store`` while the graph lives.  No launch outside
    the context takes a buffer from ``store``, and its shapes never grow,
    so the buffer is never reallocated.  Not thread-safe: the store is
    process-wide while open."""
    global _counters
    prev = _counters
    _counters = store
    try:
        yield store
    finally:
        _counters = prev


def _counter_buffer(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters, one a (row, kv head, row
    tile), for launches on ``stream`` of ``device``.  A launch counts
    its tiles' finished splits there and leaves every counter at 0 again,
    so launches on one stream, which run one after another, share the
    buffer; launches on another stream, which may run at the same time,
    get a buffer of their own.  A launch cut off mid-grid (a device fault)
    leaves the buffer unknown, as it leaves the CUDA context."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _split(limit: int):
    """(split_len, nsplit) for a walk over ``limit`` keys; every build
    needs a split length that is a multiple of 8 (a warp's 8-key group
    must not straddle a split, block or granule)."""
    split_len = max(1, int(flags.flag("decode_attention_block_kv")))
    if split_len % 8:
        raise NotImplementedError(
            f"{NAME}: the kernel takes a split length "
            f"(FLAGS_decode_attention_block_kv) % 8 == 0, got {split_len}")
    return split_len, max(1, math.ceil(limit / split_len))


def _prepare(q: torch.Tensor, hkv: int, L: int, pos, scale, live_len):
    """The arguments every launch shares over a cache of logical length
    ``L``: (keep, pos pointer, (partial-sum pointer, max/normaliser
    pointer, counters pointer), (limit, split_len, nsplit, scale),
    stream).  ``keep`` holds the tensors behind the pointers: the caller
    keeps it until the launch is enqueued, so no allocation made before
    then can take their memory."""
    b, s, hq, d = q.shape
    limit = L if live_len is None else max(1, min(L, int(live_len)))
    split_len, nsplit = _split(limit)
    st = stream_ptr(q.device)
    row_tiles = -(-s * (hq // hkv) // MMA_ROWS)
    counters = _counter_buffer(q.device, st, b * hkv * row_tiles)
    pos_t = pos_vector(pos, b, q.device)
    part, po, pml = _scratch(q, hkv, nsplit)
    if scale is None:
        scale = d ** -0.5
    return ((pos_t, part), pos_t.data_ptr(), (po, pml, counters.data_ptr()),
            (limit, split_len, nsplit, float(scale)), st)


def _check_batch(q: torch.Tensor, cache: torch.Tensor) -> None:
    if cache.shape[0] != q.shape[0]:
        raise ValueError(f"{NAME}: batch mismatch between q "
                         f"{tuple(q.shape)} and cache {tuple(cache.shape)}")


def _check_block_len(bl: int) -> None:
    if bl % 8:
        raise NotImplementedError(
            f"{NAME}: the paged build takes block_len % 8 == 0, got {bl}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos,
                          scale: Optional[float] = None,
                          live_len: Optional[int] = None) -> torch.Tensor:
    """Launch K1.  q: (B, s, Hq, D); k_cache/v_cache: (B, L, Hkv, D), the
    new K/V already written; ``pos``: int or (B,) int tensor.  Returns
    (B, s, Hq, D) in q.dtype.  Each CTA walks at most
    ``FLAGS_decode_attention_block_kv`` keys (a multiple of 8).  Raises on
    what the kernel does not take."""
    code = check_attention_args(NAME, q, k_cache, v_cache, HEAD_DIM)
    _check_batch(q, k_cache)
    b, s, hq, d = q.shape
    _, L, hkv, _ = k_cache.shape
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    keep, pos_p, scratch, walk, st = _prepare(q, hkv, L, pos, scale,
                                              live_len)
    lib = _lib(q.dtype)
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_p,
        out.data_ptr(), *scratch, b, s, hq, hkv, d, L, *walk, code, st)
    _build.check(lib, NAME, err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, pos,
                                block_tables: torch.Tensor,
                                scale: Optional[float] = None,
                                live_len: Optional[int] = None
                                ) -> torch.Tensor:
    """Launch K1-paged.  q: (B, s, Hq, D); k_pool/v_pool: one layer's
    (num_blocks, block_len, Hkv, D) pool, the new K/V already written;
    ``pos``: int or (B,) int tensor; ``block_tables``: int (B,
    max_blocks), every entry a valid block id.  Returns (B, s, Hq, D) in
    q.dtype.  Raises on what the kernel does not take, including a
    ``block_len`` that is not a multiple of 8."""
    code = check_attention_args(NAME, q, k_pool, v_pool, HEAD_DIM)
    b, s, hq, d = q.shape
    _, bl, hkv, _ = k_pool.shape
    _check_block_len(bl)
    table = block_table(block_tables, b, q.device, NAME)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    mb = table.shape[1]
    keep, pos_p, scratch, walk, st = _prepare(q, hkv, mb * bl, pos, scale,
                                              live_len)
    lib = _lib(q.dtype)
    err = lib.decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_p,
        table.data_ptr(), out.data_ptr(), *scratch, b, s, hq, hkv, d, mb, bl,
        *walk, code, st)
    _build.check(lib, NAME, err)
    decode_attention_paged_cuda.launches += 1
    return out


decode_attention_paged_cuda.launches = 0


def decode_attention_int8_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos,
                               k_scale: torch.Tensor, v_scale: torch.Tensor,
                               scale: Optional[float] = None,
                               live_len: Optional[int] = None
                               ) -> torch.Tensor:
    """Launch K1-int8 over a contiguous int8 cache.  q: (B, s, Hq, D);
    k_cache/v_cache: int8 (B, L, Hkv, D), the new K/V already written;
    k_scale/v_scale: float32 (B, n_gran, Hkv), granules of ``L // n_gran``
    positions (a multiple of 8).  Returns (B, s, Hq, D) in q.dtype.
    Raises on what the kernel does not take."""
    code = check_attention_args(NAME, q, k_cache, v_cache, HEAD_DIM,
                                int8=True)
    _check_batch(q, k_cache)
    b, s, hq, d = q.shape
    _, L, hkv, _ = k_cache.shape
    n_gran = k_scale.shape[1] if k_scale.dim() == 3 else 0
    check_scales(NAME, k_cache, k_scale, v_scale, (b, n_gran, hkv))
    if n_gran < 1 or L % n_gran or (L // n_gran) % 8:
        raise NotImplementedError(
            f"{NAME}: int8 scale granules must split L = {L} into pieces "
            f"that are multiples of 8, got n_gran = {n_gran}")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    keep, pos_p, scratch, walk, st = _prepare(q, hkv, L, pos, scale,
                                              live_len)
    lib = _lib(q.dtype)
    err = lib.decode_attention_int8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos_p, out.data_ptr(),
        *scratch, b, s, hq, hkv, d, L, n_gran, *walk, code, st)
    _build.check(lib, NAME, err)
    decode_attention_int8_cuda.launches += 1
    return out


decode_attention_int8_cuda.launches = 0


def decode_attention_paged_int8_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor, pos,
                                     block_tables: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     scale: Optional[float] = None,
                                     live_len: Optional[int] = None
                                     ) -> torch.Tensor:
    """Launch K1-paged-int8.  q: (B, s, Hq, D); k_pool/v_pool: one layer's
    int8 (num_blocks, block_len, Hkv, D) pool, the new K/V already
    written; k_scale/v_scale: float32 (num_blocks, Hkv);
    ``block_tables``: int (B, max_blocks), every entry a valid block id.
    Returns (B, s, Hq, D) in q.dtype.  Raises on what the kernel does not
    take, including a ``block_len`` that is not a multiple of 8."""
    code = check_attention_args(NAME, q, k_pool, v_pool, HEAD_DIM,
                                int8=True)
    b, s, hq, d = q.shape
    n_pool, bl, hkv, _ = k_pool.shape
    check_scales(NAME, k_pool, k_scale, v_scale, (n_pool, hkv))
    _check_block_len(bl)
    table = block_table(block_tables, b, q.device, NAME)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    mb = table.shape[1]
    keep, pos_p, scratch, walk, st = _prepare(q, hkv, mb * bl, pos, scale,
                                              live_len)
    lib = _lib(q.dtype)
    err = lib.decode_attention_paged_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos_p, table.data_ptr(),
        out.data_ptr(), *scratch, b, s, hq, hkv, d, mb, bl, *walk, code, st)
    _build.check(lib, NAME, err)
    decode_attention_paged_int8_cuda.launches += 1
    return out


decode_attention_paged_int8_cuda.launches = 0
