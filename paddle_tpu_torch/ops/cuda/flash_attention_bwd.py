"""Flash-attention backward — kernels K5 (dq) and K6 (dk, dv) of the port
(source: ``paddle_tpu_torch/csrc/flash_attention_bwd.cu``).

Replace ``paddle_tpu/ops/pallas/flash_attention.py`` ``_bwd_dq_kernel``
(:252, its ``pallas_call`` :377) and ``_bwd_dkv_kernel`` (:299, :407): the
Flash-2 backward from (q, k, v, dO, lse, delta), scores recomputed
blockwise, ``delta = rowsum(dO * O) - dlse``.  The same contract as K2:
bottom-right causal offset ``Skv - Sq``, GQA (kv head = h // G), optional
packed-document segment ids, ragged Sq / Skv masked in the kernel, tiles
above the diagonal skipped, and zero gradient for a row with every key
masked.

Bound on the H100: operations (14 * D FLOPs a visible query-key pair on
the bf16 tensor cores; at float32, three TF32 passes: 494.7 / 3 = 165
TFLOP/s).  What the design does about it: the bfloat16
builds are Hopper kernels — ``wgmma`` for all four products, TMA into
``mbarrier`` rings fed by a producer warp, two consumer warpgroups.  Up to
D 128 (128-wide tiles whose columns past D TMA fills with zeros: DiT-XL/2's
72 pays 1.78x the useful products) K5 gives a CTA 128 queries of one q
head, holds Q and dO, and streams 64-key K / V tiles; K6 gives a CTA 128
keys of one KV head, holds K and V, and walks every q head of its GQA
group over the 64-query tiles at or below the diagonal, so dk and dv are
summed over the group in float32 registers and rounded once — the (B, Hq,
Skv, D) per-q-head partials the reference writes and sums (:428-440) never
exist.  Above D 128 the tiles are 256 wide (4 boxes of 64 columns, zeros
past D; 1.88x the useful products at D 136): K5 keeps its 128 queries
(Q and dO 128 KB) and streams 32-key K / V tiles through a 3-stage ring
(231,248 bytes of shared memory); K6 takes 64 keys a CTA and, since a 64 x
256 float32 dk and dv are 256 registers a thread together, splits them
between its consumer warpgroups — one owns dV, the other dK, both
computing S^T (S^T done twice: 5 products a tile pair for 4).  Two
kernels and no atomics: every gradient is the same from run to run.  With
segment ids every build skips the tile pairs whose id ranges miss
(:func:`backward_tile_ranges`).  float16 runs the bf16 bodies compiled
over float16 (a library of its own, ``_build.VARIANTS``), each row of dS
rounded in a power-of-two unit of its own so that a loss-scaled dS
cannot pass float16's 65504 (``csrc/flash_attention_bwd.cu``).  Head dims
(``BWD_HEAD_DIMS``): K2's set, every dtype at any D <= 256 with D % 8 ==
0.  float32 runs one body for both kernels and every D on the tensor
cores in three TF32 passes (``csrc/mma_tf32.cuh``: each operand split
into a TF32 hi and lo, lo hi + hi lo + hi hi on ``mma.sync`` m16n8k8 into
float32), replacing CUDA-core bodies that ran 9-12x their bound: 8 warps
a CTA (K5 128 queries, K6 64 keys; 32 rows above D 128, where shared
memory admits no more), the other side's 32-row tiles streaming by
``cp.async`` through a ring of 2-3 stages; S / dP of a row group's
slices, P / dS exchanged through shared memory in C-fragment order and
used as the next product's A operand under a permuted k order; each
64-row block of streamed rows summed apart (K6: a 64-query tile of one q
head, as the reference's block dots).  Any other pair raises naming
ROADMAP B2, before a launch.  Each wrapper counts its launches in
``.launches``, and in ``.by_shape`` by (head_dim, Sq, Skv, causal).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from . import (_build, check_attention_args, library,
               require_cuda, stream_ptr)
from .flash_attention import (FWD_HEAD_DIMS, RANGE_TILE, _ptr,
                              segment_args, segment_tile_ranges)

NAME = "flash_attention_bwd"
# K5 / K6 take K2's head dims, every dtype
BWD_HEAD_DIMS = FWD_HEAD_DIMS

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(dtype: torch.dtype) -> ctypes.CDLL:
    """The library of ``dtype``'s build (float16: its own), its entries'
    argument types set once."""
    lib = _build.load(library(NAME, dtype))
    fq = lib.flash_attention_bwd_dq
    if fq.argtypes is None:
        # q k v dout lse delta seg_q seg_kv q_rng kv_rng dq; B Sq Skv Hq
        # Hkv D; scale; causal dtype; stream
        fq.argtypes = [_P] * 11 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
        fq.restype = ctypes.c_int
        fk = lib.flash_attention_bwd_dkv
        # q k v dout lse delta seg_q seg_kv q_rng kv_rng dk dv; B Sq Skv
        # Hq Hkv D; ...
        fk.argtypes = [_P] * 12 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
        fk.restype = ctypes.c_int
    return lib


def _check(q, k, v, do, lse, delta):
    """The checks of :func:`check_attention_args` at ``BWD_HEAD_DIMS``,
    and dO, lse, delta's shapes."""
    code = check_attention_args(NAME, q, k, v, BWD_HEAD_DIMS)
    require_cuda(NAME, do, lse, delta)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{NAME}: dO must be {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(do.shape)} {do.dtype}")
    if k.shape[0] != b:
        raise ValueError(f"{NAME}: batch mismatch between "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq):
            raise ValueError(f"{NAME}: {name} must be float32 "
                             f"{(b, hq, sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if any(t.data_ptr() % 16 for t in (do, lse, delta)):
        raise NotImplementedError(f"{NAME}: tensors must be 16-byte aligned")
    return code


def backward_tile_ranges(segment_ids: torch.Tensor,
                         kv_segment_ids: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_rng, kv_rng): the int32 [min, max] id of every ``RANGE_TILE``
    queries and keys (:func:`segment_tile_ranges`), (B, ceil(S / 64), 2)
    each.  K5 and K6 skip every tile pair whose ranges miss (a 128-token
    tile takes the union of its two ranges).  ``kv_segment_ids`` defaults
    to ``segment_ids``."""
    q_rng = segment_tile_ranges(segment_ids, RANGE_TILE)
    kv_rng = (q_rng if kv_segment_ids is None
              else segment_tile_ranges(kv_segment_ids, RANGE_TILE))
    return q_rng, kv_rng


def _segments(q, skv, segment_ids, kv_segment_ids):
    """(seg_q, seg_kv, q_rng, kv_rng) for the C entry: int32 ids on q's
    device, 16-byte aligned (the 16-bit kernels load them by TMA), and
    their tile ranges."""
    b, sq = q.shape[:2]
    seg_q, seg_kv = segment_args(NAME, segment_ids, kv_segment_ids, b, sq,
                                 skv, q.device)
    if seg_q is None:
        return seg_q, seg_kv, None, None
    seg_q, seg_kv = (t.clone() if t.data_ptr() % 16 else t
                     for t in (seg_q, seg_kv))
    q_rng, kv_rng = backward_tile_ranges(
        seg_q, None if kv_segment_ids is None else seg_kv)
    return seg_q, seg_kv, q_rng, kv_rng


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                causal: bool = False,
                                scale: Optional[float] = None,
                                segment_ids=None,
                                kv_segment_ids=None) -> torch.Tensor:
    """Launch K5.  q, dO: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); lse,
    delta: float32 (B, Hq, Sq).  Returns dq (B, Sq, Hq, D) in q.dtype."""
    code = _check(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    seg_q, seg_kv, q_rng, kv_rng = _segments(q, skv, segment_ids,
                                             kv_segment_ids)
    if b == 0 or sq == 0 or skv == 0:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    lib = _lib(q.dtype)
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
        _ptr(q_rng), _ptr(kv_rng), dq.data_ptr(), b, sq, skv, hq, hkv, d,
        float(d ** -0.5 if scale is None else scale), int(causal), code,
        stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_bwd_dq_cuda.launches += 1
    flash_attention_bwd_dq_cuda.by_shape[(d, sq, skv, bool(causal))] += 1
    return dq


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dq_cuda.by_shape = collections.Counter()


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 segment_ids=None, kv_segment_ids=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6.  Arguments as :func:`flash_attention_bwd_dq_cuda`.
    Returns (dk, dv), each (B, Skv, Hkv, D) in k.dtype and summed over the
    GQA group of its KV head."""
    code = _check(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    seg_q, seg_kv, q_rng, kv_rng = _segments(q, skv, segment_ids,
                                             kv_segment_ids)
    if b == 0 or sq == 0 or skv == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib(q.dtype)
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
        _ptr(q_rng), _ptr(kv_rng), dk.data_ptr(), dv.data_ptr(), b, sq, skv,
        hq, hkv, d, float(d ** -0.5 if scale is None else scale),
        int(causal), code, stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_bwd_dkv_cuda.launches += 1
    flash_attention_bwd_dkv_cuda.by_shape[(d, sq, skv, bool(causal))] += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0
flash_attention_bwd_dkv_cuda.by_shape = collections.Counter()
