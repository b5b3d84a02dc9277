"""Paged KV cache: block allocator + prefix cache for the serving engine
(mirrors ``paddle_tpu/serving/kv_cache.py``).

The vLLM PagedAttention memory model: the device cache is ONE pooled
tensor ``(L, 2, num_blocks, block_len, Hkv, D)`` of fixed-size KV blocks,
and each slot owns a *block table*, the ordered list of physical block ids
that back its logical positions.  Cache cost becomes live tokens plus
shared prefixes instead of ``num_slots x max_length``.

This module is host-side bookkeeping only (a free-list allocator,
per-slot block chains, refcounts, a prefix trie, an eviction LRU, and the
numpy table rows the engine uploads each tick), ported from the reference
nearly verbatim.  The device side dereferences the table in the attention
kernels (``ops/cuda/decode_attention.py``, ``ops/cuda/flash_attention.py``)
and their plain version (``ops/attention.py``); writes are (physical
block, offset) index writes in ``models/llama.py``.

Conventions the device side relies on (the reference's):

  * **block 0 is the null block**, never allocated.  Table rows are
    zero-filled past a slot's chain, so every entry is a valid pool index:
    dead-tail reads land in scratch (and are masked by position), and
    prompt-pad writes are steered there;
  * a slot's table covers ``[0, len(chain) * block_len)``; the engine
    grows the chain (``ensure_capacity``) before any step that writes past
    it;
  * full *prompt* blocks are immutable once written, so they are shared
    and trie-cached without copies.

Prefix cache: full prompt blocks are registered in a chain-keyed trie
(``(parent_block_id, block tokens) -> block_id``).  A later prompt that
starts with the same token blocks adopts the chain (refcount bump, no
recompute) and its prefill runs only the suffix; the match is capped at
``(prompt_len - 1) // block_len`` blocks so at least one token is left to
produce the first logits.  Retired registered blocks park on an LRU and
are revived by later hits; allocation under pressure evicts the LRU head
and cascades the unregistration through its trie descendants.

Admission is reservation-based, so growth mid-flight cannot fail.

int8 pool (``kv_dtype="int8"``): every block holds int8 K/V with one
float32 scale per (block, kv head) (:func:`init_paged_kv_cache`).  A block
newly appended to a chain is *fresh* (:meth:`BlockManager.drain_fresh`):
the engine zeroes its device scale row before the next dispatch, so a
reused block's stale scale never coarsens its new tenant's running-max
quantization.  COW destinations are not fresh (the device copy carries
the source's live scale).

Chunked admission (``admit(chunked=True)``) allocates only the adopted
prefix and registers nothing: the chunked engine grows the chain per
chunk (``ensure_capacity``) and registers the prompt's full blocks with
:meth:`BlockManager.register_prompt_upto` only after the chunk that writes
them is dispatched, so an unwritten block never satisfies a lookup.

Speculative rollback (:meth:`BlockManager.truncate_to`) returns the blocks
a rejected draft suffix was written into.  Not ported here, each raising
``NotImplementedError`` naming its ROADMAP item: the host tier,
swap-out/resume, block export/import and ``preempt_free`` (A6.6); the
``mixed`` pool (A6.4b).  ``stats`` is a plain dict (the metrics registry
is A5b).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import default_device

__all__ = ["BlockManager", "NULL_BLOCK", "init_paged_kv_cache"]

NULL_BLOCK = 0          # physical block 0: pad/dummy scratch, never allocated
_ROOT = -1              # trie parent id of a prompt's first block

_STATS_KEYS = ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens",
               "evictions", "cow_copies", "peak_blocks_in_use")


def init_paged_kv_cache(config, num_blocks: int, block_len: int, dtype=None,
                        quantized: bool = False, device=None):
    """Pooled paged cache: zeros (L, 2, num_blocks, block_len, kv_heads,
    head_dim) in the model dtype (or ``dtype``), on ``device`` (the card
    unless ``device="cpu"``).

    ``quantized``: the int8 pool ``{"kv": int8 (L, 2, nb, bl, Hkv, D),
    "scale": float32 (L, 2, nb, Hkv)}`` where ``scale[l, kv, b, h]`` is
    physical block ``b``'s per-kv-head dequant factor (absmax/127, a
    running max over the block's writes); a zero scale is an empty
    block."""
    dev = default_device(device)
    shape = (config.num_hidden_layers, 2, num_blocks, block_len,
             config.num_key_value_heads, config.head_dim)
    if quantized:
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=dev),
                "scale": torch.zeros(
                    (shape[0], 2, num_blocks, config.num_key_value_heads),
                    dtype=torch.float32, device=dev)}
    dt = dtype if dtype is not None else config.torch_dtype
    return torch.zeros(shape, dtype=dt, device=dev)


class _SlotAlloc:
    __slots__ = ("chain", "reserved_left")

    def __init__(self, chain: List[int], reserved_left: int):
        self.chain = chain
        self.reserved_left = reserved_left


class BlockManager:
    """Host-side allocator for a pool of ``num_blocks`` KV blocks of
    ``block_len`` tokens (block 0 reserved as the null block).

    ``kv_dtype``: ``"bf16"`` (the model dtype) or ``"int8"``; ``"mixed"``
    is ROADMAP A6.4b.

    ``stats``: ``prefix_lookups`` (admissions that consulted the trie),
    ``prefix_hit_blocks`` / ``prefix_hit_tokens`` (adopted instead of
    recomputed), ``evictions`` (cached blocks reclaimed under pressure),
    ``cow_copies`` (``ensure_writable`` copies), ``peak_blocks_in_use``
    (high-water mark of referenced blocks), ``quantized_blocks``,
    ``bytes_by_dtype`` and ``kv_dtype`` (see :meth:`quantized_blocks`,
    :meth:`set_block_nbytes`)."""

    def __init__(self, num_blocks: int, block_len: int,
                 prefix_cache: bool = True, kv_dtype: str = "bf16",
                 host_blocks: int = 0):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the null block), "
                f"got {num_blocks}")
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if kv_dtype == "mixed":
            raise NotImplementedError(
                "BlockManager(kv_dtype='mixed'), the mixed bf16/int8 pool, "
                "is ROADMAP A6.4b")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be bf16|int8|mixed, got {kv_dtype!r}")
        if host_blocks:
            raise NotImplementedError(
                "BlockManager(host_blocks > 0), the host tier, is ROADMAP "
                "A6.6")
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.prefix_cache = bool(prefix_cache)
        self.kv_dtype = kv_dtype
        # bytes per block by element dtype, set by the engine (the manager
        # has no model dimensions); feeds stats["bytes_by_dtype"]
        self._block_nbytes: Dict[str, int] = {}
        # blocks appended to a chain since the last drain_fresh()
        self._fresh: Set[int] = set()
        self._free: Deque[int] = deque(range(1, num_blocks))
        self._ref = np.zeros(num_blocks, np.int64)
        self._reserved = 0                       # admitted-but-unallocated
        self._slots: Dict[int, _SlotAlloc] = {}
        # chain-keyed trie: (parent block id, this block's tokens) -> id
        self._trie: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._block_key: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._children: Dict[int, Set[int]] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref==0 cached
        self._counts: Dict[str, int] = dict.fromkeys(_STATS_KEYS, 0)

    # -- accounting --------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        """Pool capacity a request can ever draw on (excludes the null
        block; includes blocks parked on the eviction LRU)."""
        return self.num_blocks - 1

    def blocks_in_use(self) -> int:
        """Blocks referenced by at least one live chain."""
        return int((self._ref > 0).sum())

    def cached_blocks(self) -> int:
        """Retired prefix blocks kept for future hits (evictable)."""
        return len(self._lru)

    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def stats(self) -> Dict[str, object]:
        """The counters (``_STATS_KEYS``) plus ``quantized_blocks``,
        ``bytes_by_dtype`` and ``kv_dtype``, read now."""
        return dict(self._counts, quantized_blocks=self.quantized_blocks(),
                    bytes_by_dtype=self.bytes_by_dtype(),
                    kv_dtype=self.kv_dtype)

    def _live_mask(self) -> np.ndarray:
        live = self._ref > 0
        if self._lru:
            live[list(self._lru)] = True
        return live

    def quantized_blocks(self) -> int:
        """Live (referenced or LRU-cached) blocks holding int8 content: all
        live blocks of an int8 pool, none of a bf16 one (the mixed pool,
        A6.4b, is where blocks of one pool would differ)."""
        return int(self._live_mask().sum()) if self.kv_dtype == "int8" else 0

    def set_block_nbytes(self, by_dtype: Dict[str, int]) -> None:
        """Engine-supplied bytes of one block (payload + scale share) by
        element dtype; arms ``stats["bytes_by_dtype"]``."""
        self._block_nbytes = {k: int(v) for k, v in by_dtype.items()}

    def bytes_by_dtype(self) -> Dict[str, int]:
        """Live pool bytes by element dtype (zeros until
        :meth:`set_block_nbytes`)."""
        live = int(self._live_mask().sum())
        return {dt: (live if dt == self.kv_dtype else 0)
                * self._block_nbytes.get(dt, 0) for dt in ("bf16", "int8")}

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case blocks a request needs over its whole lifetime
        (positions 0 .. prompt_len + max_new_tokens - 1)."""
        return -(-(prompt_len + max_new_tokens) // self.block_len)

    def _available(self) -> int:
        return len(self._free) + len(self._lru) - self._reserved

    # -- admission ---------------------------------------------------------

    def admit(self, slot: int, prompt: Sequence[int], prompt_len: int,
              max_new_tokens: int, chunked: bool = False) -> Optional[int]:
        """Admit a request into ``slot``: match the prompt against the
        prefix trie, reserve every block the request could need, allocate
        the blocks covering positions ``[0, prompt_len]`` now, and
        register the prompt's full blocks for future sharing (the wave
        writes them in the same scheduler call).

        Returns the number of prefix TOKENS adopted from the cache, or
        ``None`` when the pool cannot cover the request yet (the caller
        keeps it queued).  The match is capped at
        ``(prompt_len - 1) // block_len`` blocks.

        ``chunked``: the chunked-prefill contract — the prompt is written
        chunk by chunk over several ticks, so no block past the adopted
        prefix is allocated now (the engine grows the chain per chunk;
        the reservation still covers the worst case) and nothing is
        registered (:meth:`register_prompt_upto`, after each chunk)."""
        if slot in self._slots:
            raise ValueError(f"slot {slot} already has an allocation")
        bl = self.block_len
        prompt = [int(t) for t in prompt[:prompt_len]]
        matched: List[int] = []
        if self.prefix_cache:
            self._counts["prefix_lookups"] += 1
            parent = _ROOT
            for b in range((prompt_len - 1) // bl):
                bid = self._trie.get((parent, tuple(prompt[b * bl:
                                                           (b + 1) * bl])))
                if bid is None:
                    break
                matched.append(bid)
                parent = bid
        m = len(matched)
        need = self.blocks_needed(prompt_len, max_new_tokens) - m
        # a revived LRU block stops being evictable, so count the match
        # against availability too
        revive = sum(1 for bid in matched if self._ref[bid] == 0)
        if self._available() - revive < need:
            return None
        for bid in matched:                      # adopt the shared chain
            if self._ref[bid] == 0:
                self._lru.pop(bid, None)
            self._ref[bid] += 1
        st = _SlotAlloc(list(matched), need)
        self._slots[slot] = st
        self._reserved += need
        if not chunked:
            # blocks covering positions [0, prompt_len]: the prefill
            # writes the suffix and the first decode step writes position
            # prompt_len
            for _ in range(prompt_len // bl + 1 - m):
                self._append_block(st)
            if self.prefix_cache:
                self._register_prompt(st.chain, prompt, prompt_len)
        self._counts["prefix_hit_blocks"] += m
        self._counts["prefix_hit_tokens"] += m * bl
        self._note_peak()
        return m * bl

    def register_prompt_upto(self, slot: int, prompt: Sequence[int],
                             upto: int):
        """Chunked-prefill registration: insert the prompt's full blocks
        whose every token is among the first ``upto`` WRITTEN tokens.
        Idempotent; the engine calls it after each chunk's step is
        dispatched (stream order puts any adopter's reads after the
        writes), so prefix hits become available chunk by chunk."""
        if not self.prefix_cache:
            return
        st = self._slots[slot]
        self._register_prompt(st.chain, [int(t) for t in prompt[:upto]],
                              int(upto))

    def _register_prompt(self, chain: List[int], prompt: List[int],
                         prompt_len: int):
        """Insert the prompt's FULL blocks into the trie.  The block
        holding position ``prompt_len`` onward is still being written by
        decode and stays private."""
        bl = self.block_len
        parent = _ROOT
        for b in range(prompt_len // bl):
            bid = chain[b]
            key = (parent, tuple(prompt[b * bl:(b + 1) * bl]))
            if key not in self._trie and bid not in self._block_key:
                self._trie[key] = bid
                self._block_key[bid] = key
                if parent != _ROOT:
                    self._children.setdefault(parent, set()).add(bid)
            parent = self._trie.get(key, bid)

    # -- growth / writes ---------------------------------------------------

    def _pop_block(self) -> int:
        if self._free:
            return self._free.popleft()
        return self._evict_one()

    def _append_block(self, st: _SlotAlloc) -> int:
        if st.reserved_left <= 0:
            raise RuntimeError(
                "block allocation beyond the slot's admission reservation "
                "(engine bug: reservation must cover prompt + max_new)")
        bid = self._pop_block()
        self._ref[bid] = 1
        self._fresh.add(bid)
        st.chain.append(bid)
        st.reserved_left -= 1
        self._reserved -= 1
        return bid

    def drain_fresh(self) -> List[int]:
        """Physical ids of blocks appended to chains since the last call
        (cleared on read): the int8 engine zeroes their device scale rows
        before its next dispatch.  COW destinations are not included."""
        out = sorted(self._fresh)
        self._fresh.clear()
        return out

    def ensure_capacity(self, slot: int, pos: int) -> bool:
        """Grow ``slot``'s chain until it covers position ``pos``.
        Returns True when blocks were appended (table row changed)."""
        st = self._slots[slot]
        grew = False
        while len(st.chain) * self.block_len <= pos:
            self._append_block(st)
            grew = True
        if grew:
            self._note_peak()
        return grew

    def ensure_writable(self, slot: int,
                        logical_block: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard: make ``slot``'s ``logical_block`` private.
        Returns ``(src, dst)`` physical ids when a copy is needed (the
        caller copies the device block src -> dst), else None.  The fresh
        block is not covered by the admission reservation (COW cannot
        occur in the append-only engine flow)."""
        st = self._slots[slot]
        src = st.chain[logical_block]
        if self._ref[src] <= 1:
            return None
        dst = self._pop_block()
        self._ref[src] -= 1
        self._ref[dst] = 1
        st.chain[logical_block] = dst
        self._counts["cow_copies"] += 1
        self._note_peak()
        return src, dst

    # -- retirement / eviction --------------------------------------------

    def release(self, slot: int):
        """Retire a slot: drop its references and its unused reservation.
        Trie-registered blocks that reach refcount 0 park on the eviction
        LRU; anonymous blocks return to the free list."""
        st = self._slots.pop(slot)
        self._reserved -= st.reserved_left
        for bid in st.chain:
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                if bid in self._block_key:
                    self._lru[bid] = None
                    self._lru.move_to_end(bid)
                else:
                    self._free.append(bid)

    def _evict_one(self) -> int:
        """Reclaim the LRU cached block, cascading the unregistration
        through its trie descendants."""
        if not self._lru:
            raise RuntimeError(
                "KV block pool exhausted: no free or evictable blocks "
                "(reservation accounting should have prevented this)")
        bid, _ = self._lru.popitem(last=False)
        self._counts["evictions"] += 1
        self._unregister_cascade(bid)
        return bid

    def _unregister_cascade(self, bid: int):
        """Drop ``bid``'s trie registration and every descendant's (their
        chain keys dangle once the parent id is reused).  Cached
        descendants move to the free list; live ones just lose their trie
        entry."""
        stack = [bid]
        while stack:
            b = stack.pop()
            key = self._block_key.pop(b, None)
            if key is not None:
                self._trie.pop(key, None)
            stack.extend(self._children.pop(b, ()))
            if b != bid and b in self._lru:
                del self._lru[b]
                self._free.append(b)

    def truncate_to(self, slot: int, pos: int):
        """Roll ``slot``'s chain back to cover exactly positions ``[0,
        pos)`` — the speculative engine's rollback after the verify step
        rejected a draft suffix (the reference's ``truncate_to``,
        ``paddle_tpu/serving/kv_cache.py:1057``).  A no-op when the chain
        is within ``pos`` already.  In order:

          * every registered block from chain index ``pos // block_len`` on
            is cascade-unregistered before anything is freed: the block at
            the cut is rewritten in place from ``pos`` on, removed blocks
            may be reused for anything, and a later lookup must never be
            served by either (in the engine only generated positions roll
            back, so the prompt's registered blocks lie below the cut);
          * removed blocks are deref'd, not freed outright: a block shared
            with another chain (copy-on-write, an adopted prefix) stays for
            its other owners;
          * each removed block is re-credited to the slot's reservation,
            so later growth over the same positions cannot fail."""
        st = self._slots[slot]
        if pos < 0:
            raise ValueError(f"pos must be >= 0, got {pos}")
        keep = -(-pos // self.block_len)         # blocks covering [0, pos)
        cut = pos // self.block_len              # first rewritable block
        for bid in st.chain[cut:]:
            if bid in self._block_key:
                self._unregister_cascade(bid)
        removed = st.chain[keep:]
        if not removed:
            return
        del st.chain[keep:]
        for bid in removed:
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                # unregistered above, so never parked on the LRU
                self._free.append(bid)
        st.reserved_left += len(removed)
        self._reserved += len(removed)

    # -- modes of later slices ---------------------------------------------

    def _a66(self, what: str):
        raise NotImplementedError(
            f"BlockManager.{what} (preemption / host tier / migration) is "
            f"ROADMAP A6.6")

    def swap_out(self, slot: int):
        self._a66("swap_out")

    def resume_swapped(self, slot: int, record):
        self._a66("resume_swapped")

    def export_blocks(self, slot: int, read_payload):
        self._a66("export_blocks")

    def import_blocks(self, slot: int, record, write_payload):
        self._a66("import_blocks")

    def preempt_free(self, slot: int):
        self._a66("preempt_free")

    # -- table export ------------------------------------------------------

    def table_row(self, slot: int, max_blocks: int) -> np.ndarray:
        """(max_blocks,) int32 physical ids, null-block-filled past the
        allocated chain.  A LIVE chain entry of block 0 would alias the
        null block's pad data into the row's attention window; the
        allocator never produces one, so it is asserted."""
        st = self._slots[slot]
        if len(st.chain) > max_blocks:
            raise ValueError(
                f"slot {slot} chain ({len(st.chain)} blocks) exceeds "
                f"max_blocks ({max_blocks})")
        assert NULL_BLOCK not in st.chain, (
            f"slot {slot} chain references the null block: live rows "
            f"must never map to block 0 (pad aliasing)")
        row = np.full((max_blocks,), NULL_BLOCK, np.int32)
        row[:len(st.chain)] = st.chain
        return row

    def chain(self, slot: int) -> List[int]:
        return list(self._slots[slot].chain)

    def _note_peak(self):
        self._counts["peak_blocks_in_use"] = max(
            self._counts["peak_blocks_in_use"], self.blocks_in_use())
