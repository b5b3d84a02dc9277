"""Flash-attention forward — kernel K2 of the port
(source: ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``).

Replaces ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd`` (:192) /
``_fwd_kernel`` (:128): blocked online-softmax attention over
(B, S, H, D) inputs, causal or not, with bottom-right causal alignment
(``offset = Skv - Sq``) and GQA as an index map (kv head = h // G).
Returns ``out`` and the float32 log-sum-exp ``lse`` (B, Hq, Sq); a row with
every key masked gives out = 0 and lse = -1e30.  Any Sq / Skv works: the
ragged edge is masked in the kernel (the wave-prefill bucket is 8, 16, ...,
not 128-aligned, which the Pallas kernel refuses at :73-88).  Head dims
(``FWD_HEAD_DIMS``): bf16 any D <= 128 with D % 8 == 0 — the reference's
kernel takes any D up to 256 and widens its blocks by D / 128 (:56-71);
the port keeps its 128-wide tiles with the columns past D zero-filled, so
DiT-XL/2's D = 72 runs it — float32 16, 64 and 72.  The backward K5 / K6
takes the same set; the paged builds below take D = 128 (bf16) / 16
(float32) only (``HEAD_DIM``; the rest is ROADMAP B2).

Bound on the H100: max(causal FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s); at
the prefill shapes the operations bound it.  What the design does about
it: K/V stream through shared memory in tiles with an online softmax, so
the (Sq, Skv) score matrix never reaches device memory, and tiles above
the causal diagonal are skipped.  bfloat16 — the serving waves and every
training forward at head_dim 128, the DiT blocks at 72 — runs the Hopper
kernel: 128-query
tiles on two consumer warpgroups, Q.K^T and P.V on ``wgmma`` (P re-packed
in registers as the register A operand, V MN-major from shared memory),
K/V by TMA into an mbarrier ring fed by a producer warp, the next tile's
Q.K^T issued with this tile's P.V so the softmax runs under a product,
element masks only on the tiles that need one, the heaviest q tiles
first; below head_dim 128 the same kernel runs on zero-padded tiles.
float32 — the tiny models, float32 DiTs — runs a CUDA-core kernel
(``wgmma`` has no float32 input that keeps float32 numerics).  Those are
the builds held against the plain version on the card (``chip_smoke.py``);
any other dtype or head_dim raises.

Packed documents: optional int32 ``segment_ids`` (B, Sq) and
``kv_segment_ids`` (B, Skv) (``_mask_for`` :115); query i sees key j only
where the two ids are equal, on top of the causal rule.  The bf16 kernel
skips a (q tile, key tile) pair whose id ranges
(:func:`segment_tile_ranges`, computed here per call) do not meet, and
stages each loaded key tile's ids in shared memory.  The backward is
K5/K6 (``ops/cuda/flash_attention_bwd.py``).

K2-paged (:func:`flash_attention_fwd_paged_cuda`): the paged engine's
suffix prefill, which the reference runs as the q-tiled mode of its
flash-decode kernel (``paddle_tpu/ops/pallas/decode_attention.py``
:273-281, :319-335).  It is flash attention with two changes: the causal
offset is per row (query ``i`` of row ``b`` sees keys ``j <= pos_b + i``,
keys ``j < min(pos_b + Sq, max_blocks * block_len)`` exist), and K/V come
from the pooled ``(num_blocks, block_len, Hkv, D)`` cache through an
int32 ``(B, max_blocks)`` block table.  The bfloat16 build runs the same
Hopper kernel as K2: its producer reads the table and loads each 128-key
tile by TMA as two 64-key boxes, each at its block's row (TMA has no
gather), so it takes ``block_len % 64 == 0`` (the reference's default
128 qualifies) and raises otherwise; a box half past a row's last key
repeats the first half, so no dead table column is read.  The float32
kernel takes any ``block_len``.  Neither wrapper reads ``pos`` or the
table on the host.  No ``lse`` is produced on this path.

K2-paged-int8 (:func:`flash_attention_fwd_paged_int8_cuda`): the same over
the int8 pool with float32 (num_blocks, Hkv) scales — the paged int8
engine's suffix prefill.  The Hopper kernel loads each tile's int8 boxes
by TMA into a staging ring, and its producer warpgroup converts them to
bf16 (exact) in the layout the consumers read; each 64-key half carries
its block's scales, K's folded into the scores and V's into the tile's
probabilities.  The float32 kernel dequantizes per key.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from . import (_build, block_table, check_attention_args, check_scales,
               pos_vector, stream_ptr)

NAME = "flash_attention_fwd"
# the head_dim the paged builds below take for each dtype; other head
# dims are ROADMAP B2
HEAD_DIM = {torch.bfloat16: 128, torch.float32: 16}
# the contiguous K2's head dims, and K5 / K6's (``flash_attention_bwd.py``):
# bf16 any D <= 128 with D % 8 == 0 (the Hopper kernels' 128-wide tiles,
# columns past D zero-filled by TMA, whose row stride D x 2 bytes must be a
# multiple of 16), float32 the CUDA-core kernels' instances (the tiny
# models at 16, float32 DiTs at 64 and 72)
FWD_HEAD_DIMS = {torch.bfloat16: frozenset(range(8, 129, 8)),
                 torch.float32: frozenset({16, 64, 72})}
SEG_TILE = 128          # the bf16 build's query and key tile (csrc: kHQ, kHK)
PAGED_BOX = 64          # the bf16 paged builds' key rows a box (csrc: kHBox)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        # q k v out lse seg_q seg_kv q_rng kv_rng
        fn.argtypes = [_P] * 9 + [_I, _I, _I, _I, _I, _I,  # B Sq Skv Hq Hkv D
                       ctypes.c_float, _I, _I, _P]         # scale causal dt st
        fn.restype = ctypes.c_int
        fp = lib.flash_attention_fwd_paged
        # q k v pos tbl out; B S Hq Hkv D num_blocks max_blocks bl; scale
        # dt st
        fp.argtypes = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _P]
        fp.restype = ctypes.c_int
        # q k v k_scale v_scale pos tbl out; B S Hq Hkv D num_blocks
        # max_blocks bl; scale dt st
        fi = lib.flash_attention_fwd_paged_int8
        fi.argtypes = [_P] * 8 + [_I] * 8 + [ctypes.c_float, _I, _P]
        fi.restype = ctypes.c_int
    return lib


def segment_args(what: str, segment_ids, kv_segment_ids, b: int, sq: int,
                 skv: int, device):
    """(seg_q, seg_kv) as contiguous int32 tensors on ``device``, or (None,
    None).  ``kv_segment_ids`` defaults to ``segment_ids`` (self-attention,
    sq == skv) and needs it."""
    if segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError(f"{what}: kv_segment_ids requires segment_ids")
        return None, None
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    out = []
    for name, t, n in (("segment_ids", segment_ids, sq),
                       ("kv_segment_ids", kv_segment_ids, skv)):
        if tuple(t.shape) != (b, n):
            raise ValueError(f"{what}: {name} must be ({b}, {n}), got "
                             f"{tuple(t.shape)}")
        out.append(t.to(device=device, dtype=torch.int32).contiguous())
    return out[0], out[1]


def segment_tile_ranges(ids: torch.Tensor, tile: int = SEG_TILE
                        ) -> torch.Tensor:
    """(B, ceil(S / tile), 2) int32: the [min, max] id of each ``tile``
    consecutive positions of the (B, S) ids.  K2 skips a (q tile, key
    tile) pair whose two ranges do not meet: no query of the one can share
    an id with a key of the other, for any ids."""
    b, s = ids.shape
    t = -(-s // tile)
    if t * tile > s:   # repeat the last id: no range widens
        ids = torch.cat([ids, ids[:, -1:].expand(b, t * tile - s)], 1)
    lo, hi = torch.aminmax(ids.reshape(b, t, tile), dim=-1)
    return torch.stack([lo, hi], -1).to(torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             segment_ids=None, kv_segment_ids=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); optional
    int ``segment_ids`` (B, Sq) / ``kv_segment_ids`` (B, Skv), the latter
    defaulting to the former.  Returns (out (B, Sq, Hq, D) in q.dtype, lse
    (B, Hq, Sq) float32).  Head dims: ``FWD_HEAD_DIMS``.  Raises on what
    the kernel does not take."""
    code = check_attention_args(NAME, q, k, v, FWD_HEAD_DIMS)
    b, sq, hq, d = q.shape
    bk, skv, hkv, _ = k.shape
    if bk != b:
        raise ValueError(f"{NAME}: batch mismatch between "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    seg_q, seg_kv = segment_args(NAME, segment_ids, kv_segment_ids, b, sq,
                                 skv, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return out, lse
    if scale is None:
        scale = d ** -0.5
    q_rng = kv_rng = None
    if seg_q is not None and q.dtype == torch.bfloat16:
        if seg_kv.data_ptr() % 16:   # the kernel loads key ids by TMA
            seg_kv = seg_kv.clone()
        q_rng = segment_tile_ranges(seg_q)
        kv_rng = (q_rng if kv_segment_ids is None
                  else segment_tile_ranges(seg_kv))
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(seg_q), _ptr(seg_kv), _ptr(q_rng),
        _ptr(kv_rng), b, sq, skv, hq, hkv, d, float(scale), int(causal),
        code, stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_fwd_cuda.launches += 1
    flash_attention_fwd_cuda.by_shape[(d, sq, skv, bool(causal))] += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.by_shape = collections.Counter()


def flash_attention_fwd_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor, pos,
                                   block_tables: torch.Tensor,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Launch K2-paged.  q: (B, S, Hq, D) queries at per-row offsets
    ``pos`` (int or (B,) int tensor); k_pool/v_pool: one layer's
    (num_blocks, block_len, Hkv, D) pool with this chunk's K/V already
    written; ``block_tables``: int (B, max_blocks), every entry a valid
    block id.  Returns (B, S, Hq, D) in q.dtype.  Raises on what the
    kernel does not take."""
    code = check_attention_args(NAME, q, k_pool, v_pool, HEAD_DIM)
    b, sq, hq, d = q.shape
    n_pool, bl, hkv, _ = k_pool.shape
    # the bfloat16 kernel loads 64-key boxes, each inside one block
    if q.dtype == torch.bfloat16 and bl % PAGED_BOX:
        raise NotImplementedError(
            f"{NAME}: the paged bfloat16 build takes block_len % 64 == 0, "
            f"got {bl}")
    table = block_table(block_tables, b, q.device, NAME)
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    pos_t = pos_vector(pos, b, q.device)
    if scale is None:
        scale = d ** -0.5
    lib = _lib()
    err = lib.flash_attention_fwd_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_t.data_ptr(),
        table.data_ptr(), out.data_ptr(), b, sq, hq, hkv, d, n_pool,
        table.shape[1], bl, float(scale), code, stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_fwd_paged_cuda.launches += 1
    return out


flash_attention_fwd_paged_cuda.launches = 0


def flash_attention_fwd_paged_int8_cuda(q: torch.Tensor,
                                        k_pool: torch.Tensor,
                                        v_pool: torch.Tensor, pos,
                                        block_tables: torch.Tensor,
                                        k_scale: torch.Tensor,
                                        v_scale: torch.Tensor,
                                        scale: Optional[float] = None
                                        ) -> torch.Tensor:
    """Launch K2-paged-int8.  As :func:`flash_attention_fwd_paged_cuda`
    with k_pool/v_pool one layer's int8 (num_blocks, block_len, Hkv, D)
    pool and k_scale/v_scale float32 (num_blocks, Hkv).  Raises on what the
    kernel does not take."""
    code = check_attention_args(NAME, q, k_pool, v_pool, HEAD_DIM,
                                int8=True)
    b, sq, hq, d = q.shape
    n_pool, bl, hkv, _ = k_pool.shape
    check_scales(NAME, k_pool, k_scale, v_scale, (n_pool, hkv))
    if q.dtype == torch.bfloat16 and bl % PAGED_BOX:
        raise NotImplementedError(
            f"{NAME}: the paged bfloat16 build takes block_len % 64 == 0, "
            f"got {bl}")
    table = block_table(block_tables, b, q.device, NAME)
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    pos_t = pos_vector(pos, b, q.device)
    if scale is None:
        scale = d ** -0.5
    lib = _lib()
    err = lib.flash_attention_fwd_paged_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos_t.data_ptr(),
        table.data_ptr(), out.data_ptr(), b, sq, hq, hkv, d, n_pool,
        table.shape[1], bl, float(scale), code, stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_fwd_paged_int8_cuda.launches += 1
    return out


flash_attention_fwd_paged_int8_cuda.launches = 0
