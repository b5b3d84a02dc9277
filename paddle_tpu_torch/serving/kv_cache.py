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
a rejected draft suffix was written into.

Mixed pool (``kv_dtype="mixed"``): the device pool stays in the model
dtype; every block carries a dtype tag (:meth:`BlockManager.block_dtype`).
A block is born hot (bf16) and demotes to int8 when it registers as a
cold full prefix block: ``on_demote`` fires with its id and the engine
rewrites the block in place through a quantize -> dequantize round trip.
A freed, evicted, copied-on-write or truncated block resets to the pool's
default.

Host tier (``host_blocks > 0``, the reference's tiering): a
:class:`HostTier` of ``host_blocks`` block-sized payloads in host memory
(pinned when the pool lives on the card).  Two flows feed it, each one
device copy the engine performs through the ``on_swap_out`` /
``on_swap_in`` hooks:

  * demote-on-evict: when pool pressure would drop the LRU head's
    content, the block moves to the host instead, keyed by its full token
    path from the prompt root in a host trie; a later admission whose
    prompt walk runs off the device trie continues into the host trie and
    promotes each hit into a fresh device block from its own reservation;
  * swap-out (preemption): :meth:`BlockManager.swap_out` moves a victim's
    private blocks (refcount 1) to pinned host payloads recorded in a
    resume record (shared blocks keep the victim's reference), and
    :meth:`BlockManager.resume_swapped` rebuilds the chain.  Record entries
    are never trie keys.  Swap records are never evicted; demoted trie
    entries are (oldest first), so swap capacity wins over cached-prefix
    capacity.

Migration: :meth:`BlockManager.export_blocks` serialises a chain by value
(dtype tags with the payloads) and :meth:`BlockManager.import_blocks`
materialises it into another pool.

Telemetry: the counters and pool gauges live in the metrics registry
(``kv_cache.*``, labelled ``pool=<id>``), as the reference's do; ``stats``
stays the public readout, a dict read from them now.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import default_device
from .. import observability as _obs

__all__ = ["BlockManager", "HostTier", "NULL_BLOCK", "init_paged_kv_cache"]

NULL_BLOCK = 0          # physical block 0: pad/dummy scratch, never allocated
_ROOT = -1              # trie parent id of a prompt's first block

# pool instances share the default registry; the ``pool`` label keeps
# their series apart
_POOL_IDS = itertools.count()

# the registry counters behind ``stats``: key -> help text
_COUNTERS = {
    "prefix_lookups": "admissions that consulted the prefix trie",
    "prefix_hit_blocks": "blocks adopted from the prefix cache instead of "
                         "recomputed",
    "prefix_hit_tokens": "tokens adopted from the prefix cache",
    "evictions": "cached blocks reclaimed under pool pressure",
    "cow_copies": "ensure_writable copy-on-write copies",
    "host_demotions": "cold prefix blocks demoted HBM -> host instead of "
                      "dropped under pool pressure",
    "host_promotions": "host-tier prefix blocks promoted back to HBM on an "
                       "admission hit",
    "swapped_out_blocks": "private blocks moved to pinned host buffers by "
                          "preemption swap-out",
    "swapped_in_blocks": "pinned host blocks restored to HBM by "
                         "preemption resume",
    "exported_blocks": "blocks serialized out of this pool for "
                       "cross-worker migration (export_blocks)",
    "imported_blocks": "blocks materialized into this pool from a "
                       "migration record (import_blocks)",
}


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


# a block's full token path from the prompt root: one tuple of tokens a
# block, root first -- the identity of its contents in either tier
_Path = Tuple[Tuple[int, ...], ...]


class HostTier:
    """The host-memory block pool, the device pool's second tier (the
    reference's ``HostTier``, ``paddle_tpu/serving/kv_cache.py:207``).

    Capacity is counted in blocks of the device pool's geometry; each live
    host id owns one block's payload, which the engine reads off and
    writes back through the manager's ``on_swap_out`` / ``on_swap_in``
    hooks: a tuple of CPU tensors, one a cache leaf, in pinned memory when
    the pool lives on the card (bf16 has no numpy dtype).  The tier is an
    id allocator and a payload store; which ids are evictable (demoted
    trie blocks) and which are pinned (swap records) is the
    :class:`BlockManager`'s call, so ``alloc()`` on a full tier is a
    caller bug."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ids = itertools.count()
        self._live: Set[int] = set()
        self._payload: Dict[int, object] = {}

    @property
    def used(self) -> int:
        return len(self._live)

    def free_slots(self) -> int:
        return self.capacity - len(self._live)

    def alloc(self) -> int:
        if len(self._live) >= self.capacity:
            raise RuntimeError(
                "host tier full (BlockManager must make room before "
                "allocating)")
        hid = next(self._ids)
        self._live.add(hid)
        return hid

    def put(self, hid: int, payload) -> None:
        if hid not in self._live:
            raise KeyError(f"host id {hid} is not allocated")
        self._payload[hid] = payload

    def get(self, hid: int):
        return self._payload[hid]

    def free(self, hid: int) -> None:
        self._live.remove(hid)
        self._payload.pop(hid, None)


class BlockManager:
    """Host-side allocator for a pool of ``num_blocks`` KV blocks of
    ``block_len`` tokens (block 0 reserved as the null block).

    ``kv_dtype``: ``"bf16"`` (the model dtype), ``"int8"`` or ``"mixed"``
    (a model-dtype pool whose cold full prefix blocks demote to int8;
    ``on_demote``).  ``host_blocks``: the host tier's capacity in blocks
    (0: none).

    ``stats``: ``prefix_lookups`` (admissions that consulted the trie),
    ``prefix_hit_blocks`` / ``prefix_hit_tokens`` (adopted or promoted
    instead of recomputed), ``evictions`` (cached blocks reclaimed under
    pressure), ``cow_copies`` (``ensure_writable`` copies),
    ``peak_blocks_in_use`` (high-water mark of referenced blocks),
    ``host_demotions`` / ``host_promotions`` (evicted prefix blocks moved
    to the host tier / brought back by an admission),
    ``swapped_out_blocks`` / ``swapped_in_blocks`` (preemption),
    ``exported_blocks`` / ``imported_blocks`` (migration),
    ``quantized_blocks``, ``bytes_by_dtype`` and ``kv_dtype`` (see
    :meth:`quantized_blocks`, :meth:`set_block_nbytes`)."""

    def __init__(self, num_blocks: int, block_len: int,
                 prefix_cache: bool = True, kv_dtype: str = "bf16",
                 host_blocks: int = 0):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the null block), "
                f"got {num_blocks}")
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if kv_dtype not in ("bf16", "int8", "mixed"):
            raise ValueError(
                f"kv_dtype must be bf16|int8|mixed, got {kv_dtype!r}")
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.prefix_cache = bool(prefix_cache)
        self.kv_dtype = kv_dtype
        # each block's element dtype: 0 the pool's model dtype, 1 int8.  An
        # int8 pool is born all 1; a mixed pool's blocks are born 0 and
        # demote to 1 when they register as cold full prefix blocks; a
        # freed block resets to the pool's default
        self._default_dtype = 1 if kv_dtype == "int8" else 0
        self._dtype = np.full(num_blocks, self._default_dtype, np.int8)
        # engine hooks.  on_demote(list of block ids): the mixed pool's
        # newly demoted blocks, for the device rewrite.  on_swap_out([(block
        # id, host id)]) / on_swap_in([(host id, block id)]): copy blocks
        # to / from host payloads, always before the device block can go
        # to a new owner
        self.on_demote = None
        self.on_swap_out = None
        self.on_swap_in = None
        self._host: Optional[HostTier] = (
            HostTier(host_blocks) if host_blocks > 0 else None)
        # host trie: full token path -> (host id, element dtype); insertion
        # order is the host LRU (the oldest demotion goes first when a swap
        # record needs the room)
        self._host_trie: "OrderedDict[_Path, Tuple[int, str]]" = (
            OrderedDict())
        # registered device block -> its full token path (the host-trie key
        # it keeps through a demotion)
        self._block_path: Dict[int, _Path] = {}
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
        # telemetry: counters and pool gauges in the registry, labelled
        # pool=<id> (the reference's series, help texts and update points)
        reg = _obs.default_registry()
        self._pid = str(next(_POOL_IDS))
        lbl = {"pool": self._pid}
        self._counters = {k: reg.counter(f"kv_cache.{k}", h).labels(**lbl)
                          for k, h in _COUNTERS.items()}
        self._peak = 0
        self._g_peak = reg.gauge(
            "kv_cache.peak_blocks_in_use",
            "high-water mark of referenced blocks").labels(**lbl)
        self._g_in_use = reg.gauge(
            "kv_cache.blocks_in_use",
            "blocks referenced by at least one live chain").labels(**lbl)
        self._g_occ = reg.gauge(
            "kv_cache.pool_occupancy",
            "blocks_in_use / usable_blocks").labels(**lbl)
        self._g_free = reg.gauge(
            "kv_cache.free_blocks", "free-list length").labels(**lbl)
        self._g_cached = reg.gauge(
            "kv_cache.cached_blocks",
            "retired prefix blocks parked for future hits "
            "(evictable)").labels(**lbl)
        self._g_quant = reg.gauge(
            "kv_cache.quantized_blocks",
            "live (referenced or LRU-cached) blocks holding int8 "
            "content").labels(**lbl)
        self._g_host_used = reg.gauge(
            "kv_cache.host_blocks_used",
            "host-tier blocks live (demoted trie blocks + pinned swap "
            "records)").labels(**lbl)
        self._g_host_trie = reg.gauge(
            "kv_cache.host_trie_blocks",
            "host-tier blocks holding demoted (promotable, evictable) "
            "prefix-trie content").labels(**lbl)
        f_bytes = reg.gauge(
            "kv_cache.bytes_by_dtype",
            "live pool bytes per element dtype (payload + scale share; "
            "set once the engine provides per-block byte costs)")
        self._g_bytes = {d: f_bytes.labels(dtype=d, **lbl)
                         for d in ("bf16", "int8")}
        self._refresh_gauges()

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
        """The registry counters (``_COUNTERS``) and
        ``peak_blocks_in_use``, plus ``quantized_blocks``,
        ``bytes_by_dtype`` and ``kv_dtype``, read now."""
        out: Dict[str, object] = {k: int(c.value())
                                  for k, c in self._counters.items()}
        out["peak_blocks_in_use"] = self._peak
        out.update(quantized_blocks=self.quantized_blocks(),
                   bytes_by_dtype=self.bytes_by_dtype(),
                   kv_dtype=self.kv_dtype)
        return out

    def _live_mask(self) -> np.ndarray:
        live = self._ref > 0
        if self._lru:
            live[list(self._lru)] = True
        return live

    def block_dtype(self, bid: int) -> str:
        """Element dtype of physical block ``bid``'s contents."""
        return "int8" if self._dtype[bid] else "bf16"

    def quantized_blocks(self) -> int:
        """Live (referenced or LRU-cached) blocks holding int8 content."""
        return int((self._live_mask() & (self._dtype == 1)).sum())

    def set_block_nbytes(self, by_dtype: Dict[str, int]) -> None:
        """Engine-supplied bytes of one block (payload + scale share) by
        element dtype; arms ``stats["bytes_by_dtype"]``."""
        self._block_nbytes = {k: int(v) for k, v in by_dtype.items()}
        self._refresh_gauges()

    def bytes_by_dtype(self) -> Dict[str, int]:
        """Live pool bytes by element dtype (zeros until
        :meth:`set_block_nbytes`)."""
        live = self._live_mask()
        n_int8 = int((live & (self._dtype == 1)).sum())
        return {"bf16": (int(live.sum()) - n_int8)
                * self._block_nbytes.get("bf16", 0),
                "int8": n_int8 * self._block_nbytes.get("int8", 0)}

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
        prefix trie (and past it, the host trie), reserve every block the
        request could need, allocate the blocks covering positions ``[0,
        prompt_len]`` now, and register the prompt's full blocks for
        future sharing (the wave writes them in the same scheduler call).

        Returns the number of prefix TOKENS adopted from the cache or
        promoted from the host tier, or ``None`` when the pool cannot
        cover the request yet (the caller keeps it queued).  The match is
        capped at ``(prompt_len - 1) // block_len`` blocks.  Host hits
        are promoted into fresh device blocks of this request's
        reservation (so they count as unmatched for the admission check),
        copied back through ``on_swap_in`` and registered under their
        original keys.

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
        path: _Path = ()
        promo: List[Tuple[_Path, Tuple[int, ...], Tuple[int, str]]] = []
        if self.prefix_cache:
            self._counters["prefix_lookups"].inc(1)
            parent = _ROOT
            cap = (prompt_len - 1) // bl
            for b in range(cap):
                toks = tuple(prompt[b * bl:(b + 1) * bl])
                bid = self._trie.get((parent, toks))
                if bid is None:
                    break
                path = path + (toks,)
                matched.append(bid)
                parent = bid
            if self._host is not None:
                for b in range(len(matched), cap):
                    toks = tuple(prompt[b * bl:(b + 1) * bl])
                    p = path + (toks,)
                    ent = self._host_trie.get(p)
                    if ent is None:
                        break
                    promo.append((p, toks, ent))
                    path = p
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
        if promo:
            # claim the host entries first: the allocations below may
            # evict, and an eviction's demotion may make room in the host
            # tier by dropping a still-listed promotion (freeing the very
            # payload about to be copied back).  Claimed entries keep their
            # host ids until on_swap_in has read them.  Promoted blocks are
            # not fresh: the copy restores an int8 block's scale row
            for p, _, _ in promo:
                del self._host_trie[p]
            pairs: List[Tuple[int, int]] = []
            parent = matched[-1] if matched else _ROOT
            for p, toks, (hid, dt) in promo:
                bid = self._append_block(st)
                self._fresh.discard(bid)
                self._dtype[bid] = 1 if dt == "int8" else 0
                key = (parent, toks)
                self._trie[key] = bid
                self._block_key[bid] = key
                self._block_path[bid] = p
                if parent != _ROOT:
                    self._children.setdefault(parent, set()).add(bid)
                pairs.append((hid, bid))
                parent = bid
            if self.on_swap_in is not None:
                self.on_swap_in(list(pairs))
            for hid, _ in pairs:
                self._host.free(hid)
            self._counters["host_promotions"].inc(len(pairs))
        m_blocks = m + len(promo)
        if not chunked:
            # blocks covering positions [0, prompt_len]: the prefill
            # writes the suffix and the first decode step writes position
            # prompt_len
            for _ in range(prompt_len // bl + 1 - m_blocks):
                self._append_block(st)
            if self.prefix_cache:
                self._register_prompt(st.chain, prompt, prompt_len)
        self._counters["prefix_hit_blocks"].inc(m_blocks)
        self._counters["prefix_hit_tokens"].inc(m_blocks * bl)
        self._note_peak()
        return m_blocks * bl

    def prefix_probe(self, prompt: Sequence[int],
                     prompt_len: Optional[int] = None) -> int:
        """READ-ONLY longest trie match for ``prompt``, in tokens: the
        replica router's placement probe (``serving/router.py``).  No
        refcount change, no LRU touch, no counter increment (:meth:`admit`
        stays the trie's only consumer with side effects), and capped as
        admission caps (one token must remain to produce the first
        logits), so the probe never promises more than ``admit`` would
        adopt.  The host trie is not probed, as in the reference."""
        if not self.prefix_cache:
            return 0
        n = int(prompt_len if prompt_len is not None else len(prompt))
        bl = self.block_len
        toks = [int(t) for t in prompt[:n]]
        parent = _ROOT
        m = 0
        for b in range((n - 1) // bl):
            bid = self._trie.get((parent, tuple(toks[b * bl:(b + 1) * bl])))
            if bid is None:
                break
            m += 1
            parent = bid
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
        decode and stays private.  A newly registered path's host-trie
        copy is dropped (a path lives in one tier at a time); a mixed
        pool demotes each newly registered block (``on_demote``: cold by
        definition, no writer touches a registered full block again)."""
        bl = self.block_len
        parent = _ROOT
        path: _Path = ()
        demoted: List[int] = []
        for b in range(prompt_len // bl):
            bid = chain[b]
            toks = tuple(prompt[b * bl:(b + 1) * bl])
            key = (parent, toks)
            path = path + (toks,)
            if key not in self._trie and bid not in self._block_key:
                self._trie[key] = bid
                self._block_key[bid] = key
                self._block_path[bid] = path
                if parent != _ROOT:
                    self._children.setdefault(parent, set()).add(bid)
                if self._host is not None:
                    ent = self._host_trie.pop(path, None)
                    if ent is not None:
                        self._host.free(ent[0])
                if self.kv_dtype == "mixed" and not self._dtype[bid]:
                    self._dtype[bid] = 1
                    demoted.append(bid)
            parent = self._trie.get(key, bid)
        if demoted:
            if self.on_demote is not None:
                self.on_demote(list(demoted))
            self._refresh_gauges()

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
        occur in the append-only engine flow); it comes at the pool's
        default dtype (a mixed pool's private copy is hot)."""
        st = self._slots[slot]
        src = st.chain[logical_block]
        if self._ref[src] <= 1:
            return None
        dst = self._pop_block()
        self._ref[src] -= 1
        self._ref[dst] = 1
        st.chain[logical_block] = dst
        self._counters["cow_copies"].inc(1)
        self._note_peak()
        return src, dst

    # -- retirement / eviction --------------------------------------------

    def _deref(self, bid: int):
        """Drop one reference to ``bid``: at zero, a registered block parks
        on the eviction LRU (its content and dtype persist for future
        hits), an anonymous one returns to the free list at the pool's
        default dtype."""
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            if bid in self._block_key:
                self._lru[bid] = None
                self._lru.move_to_end(bid)
            else:
                self._free.append(bid)
                self._dtype[bid] = self._default_dtype

    def release(self, slot: int):
        """Retire a slot: drop its references and its unused reservation
        (:meth:`_deref` each block)."""
        st = self._slots.pop(slot)
        self._reserved -= st.reserved_left
        for bid in st.chain:
            self._deref(bid)
        self._refresh_gauges()

    def _evict_one(self) -> int:
        """Reclaim the LRU cached block, cascading the unregistration
        through its trie descendants.  With a host tier, the block's
        content moves to the host first (``on_swap_out``, before the id
        can go to a new owner), keyed by its token path, unless the tier
        is full of swap records."""
        if not self._lru:
            raise RuntimeError(
                "KV block pool exhausted: no free or evictable blocks "
                "(reservation accounting should have prevented this)")
        bid, _ = self._lru.popitem(last=False)
        self._counters["evictions"].inc(1)
        bpath = self._block_path.get(bid)
        if (self._host is not None and bpath is not None
                and self._host_make_room(1)):
            hid = self._host.alloc()
            if self.on_swap_out is not None:
                self.on_swap_out([(int(bid), hid)])
            self._host_trie[bpath] = (hid, self.block_dtype(bid))
            self._counters["host_demotions"].inc(1)
        self._unregister_cascade(bid)
        self._dtype[bid] = self._default_dtype   # the new owner rewrites it
        return bid

    def _unregister_cascade(self, bid: int):
        """Drop ``bid``'s trie registration and every descendant's (their
        chain keys dangle once the parent id is reused).  Cached
        descendants move to the free list; live ones just lose their trie
        entry.  Host-trie entries strictly below a dropped path can never
        be reached again and are freed too (the copy AT ``bid``'s own path,
        just demoted by an eviction, stays)."""
        stack = [bid]
        while stack:
            b = stack.pop()
            key = self._block_key.pop(b, None)
            if key is not None:
                self._trie.pop(key, None)
            bpath = self._block_path.pop(b, None)
            if bpath is not None and self._host is not None:
                self._host_drop_cascade(bpath)
            stack.extend(self._children.pop(b, ()))
            if b != bid and b in self._lru:
                del self._lru[b]
                self._free.append(b)
                self._dtype[b] = self._default_dtype

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
            its other owners; a freed one resets to the pool's dtype;
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
            self._refresh_gauges()
            return
        del st.chain[keep:]
        for bid in removed:
            # unregistered above, so never parked on the LRU
            self._deref(bid)
        st.reserved_left += len(removed)
        self._reserved += len(removed)
        self._refresh_gauges()

    # -- preemption / host tier (reference kv_cache.py:768-1000) -----------

    @property
    def host_tier(self) -> Optional[HostTier]:
        """The host tier (None when ``host_blocks == 0``): the engine's
        swap hooks read and write payloads through it."""
        return self._host

    def host_blocks_used(self) -> int:
        return self._host.used if self._host is not None else 0

    def host_trie_blocks(self) -> int:
        """Host-tier blocks holding demoted (promotable) trie content; the
        rest of ``host_blocks_used`` is pinned swap records."""
        return len(self._host_trie)

    def host_cache_bytes(self) -> int:
        """Host memory the tier may take: capacity x the model-dtype block
        bytes (the worst case; payloads keep their own dtype).  Not part
        of the engine's ``cache_hbm_bytes``."""
        if self._host is None or not self._block_nbytes:
            return 0
        return self._host.capacity * self._block_nbytes.get("bf16", 0)

    def private_swap_blocks(self, slot: int) -> int:
        """How many of ``slot``'s blocks a swap-out would move to the host
        tier (refcount-1 blocks; shared blocks stay put)."""
        st = self._slots[slot]
        return sum(1 for bid in st.chain if self._ref[bid] == 1)

    def host_can_accept(self, n: int) -> bool:
        """Could the host tier take ``n`` more pinned blocks now, evicting
        demoted trie entries if it must (swap records are never evicted
        for other swap records)?"""
        if self._host is None:
            return False
        return self._host.free_slots() + len(self._host_trie) >= n

    def _host_make_room(self, n: int) -> bool:
        """Ensure ``n`` free host slots by evicting the oldest demoted trie
        entries (never swap records).  False, evicting nothing, when the
        tier cannot cover ``n``."""
        if not self.host_can_accept(n):
            return False
        while self._host.free_slots() < n:
            p, (hid, _) = self._host_trie.popitem(last=False)
            self._host.free(hid)
            self._host_drop_cascade(p)
        return True

    def _host_drop_cascade(self, path: _Path):
        """Free the host-trie entries strictly below ``path``: with their
        ancestor gone from both tiers no admission walk reaches them."""
        if self._host is None or not self._host_trie:
            return
        k = len(path)
        for p in [p for p in self._host_trie
                  if len(p) > k and p[:k] == path]:
            hid, _ = self._host_trie.pop(p)
            self._host.free(hid)

    def swap_out(self, slot: int) -> Optional[Dict[str, object]]:
        """Preempt ``slot``: tear down its allocation, moving every PRIVATE
        block (refcount 1) to a pinned host payload and keeping this slot's
        reference on every SHARED block, so the chain survives its other
        owners' releases.  Returns the resume record for
        :meth:`resume_swapped` — ``entries``, the chain in order, each
        ``("hbm", bid)`` (reference kept) or ``("host", hid, dtype)`` —
        or None when the host tier cannot take the private blocks even
        after evicting every demoted trie entry (the caller recomputes or
        skips the victim).  A swapped chain serves no prefix hit until it
        is resumed."""
        st = self._slots[slot]
        n_priv = sum(1 for bid in st.chain if self._ref[bid] == 1)
        if not self._host_make_room(n_priv):
            return None
        st = self._slots.pop(slot)
        reserved_left = st.reserved_left
        self._reserved -= reserved_left
        entries: List[Tuple] = []
        pairs: List[Tuple[int, int]] = []
        for bid in st.chain:
            if self._ref[bid] > 1:
                entries.append(("hbm", int(bid)))
                continue
            if bid in self._block_key:
                # the id is about to be freed: its trie entry (and its
                # descendants') would dangle
                self._unregister_cascade(bid)
            hid = self._host.alloc()
            entries.append(("host", hid, self.block_dtype(bid)))
            pairs.append((int(bid), hid))
            self._ref[bid] = 0
            self._free.append(bid)
            self._dtype[bid] = self._default_dtype
        if pairs:
            if self.on_swap_out is not None:
                self.on_swap_out(list(pairs))
            self._counters["swapped_out_blocks"].inc(len(pairs))
        self._fresh.difference_update(b for b, _ in pairs)
        self._refresh_gauges()
        return {"entries": entries, "reserved_left": int(reserved_left)}

    def resume_swapped(self, slot: int, record: Dict[str, object]
                       ) -> Optional[int]:
        """Rebuild a swapped-out chain into (free) ``slot``: a fresh device
        block for each ``host`` entry (payload copied back through
        ``on_swap_in``, host payload freed), each ``hbm`` entry re-adopted
        (its reference was never dropped), the remaining reservation
        re-armed.  Returns the chain length, or None when the pool cannot
        cover the host blocks and the reservation yet (the caller keeps the
        record)."""
        if slot in self._slots:
            raise ValueError(f"slot {slot} already has an allocation")
        entries = record["entries"]
        reserved = int(record["reserved_left"])
        n_host = sum(1 for e in entries if e[0] == "host")
        if self._available() < n_host + reserved:
            return None
        chain: List[int] = []
        pairs: List[Tuple[int, int]] = []
        for e in entries:
            if e[0] == "hbm":
                chain.append(int(e[1]))
                continue
            _, hid, dt = e
            bid = self._pop_block()
            self._ref[bid] = 1
            self._dtype[bid] = 1 if dt == "int8" else 0
            chain.append(bid)
            pairs.append((hid, int(bid)))
        self._slots[slot] = _SlotAlloc(chain, reserved)
        self._reserved += reserved
        if pairs:
            if self.on_swap_in is not None:
                self.on_swap_in(list(pairs))
            for hid, _ in pairs:
                self._host.free(hid)
            self._counters["swapped_in_blocks"].inc(len(pairs))
        self._note_peak()
        return len(chain)

    def drop_swap_record(self, record: Dict[str, object]):
        """Cancel a swapped-out request: free the record's host payloads
        and drop the references it kept on shared blocks (:meth:`_deref`,
        as a release does)."""
        for e in record["entries"]:
            if e[0] == "hbm":
                self._deref(int(e[1]))
            else:
                self._host.free(e[1])
        self._refresh_gauges()

    def export_blocks(self, slot: int, read_payload) -> Dict[str, object]:
        """Serialise ``slot``'s chain for migration into ANOTHER pool: one
        entry a block, in chain order, with its dtype tag and the payload
        ``read_payload(bid)`` returns (the engine reads every cache leaf's
        block, an int8 block's scale row included).  By value and
        read-only: the source chain stays live until the caller releases
        it."""
        st = self._slots[slot]
        entries: List[Dict[str, object]] = [
            {"dtype": self.block_dtype(bid),
             "payload": read_payload(int(bid))} for bid in st.chain]
        self._counters["exported_blocks"].inc(len(entries))
        return {"entries": entries,
                "reserved_left": int(st.reserved_left),
                "block_len": int(self.block_len)}

    def import_blocks(self, slot: int, record: Dict[str, object],
                      write_payload) -> Optional[int]:
        """Materialise an exported chain into (free) ``slot`` of THIS pool:
        a device block an entry with its dtype tag, its payload handed to
        ``write_payload(bid, payload)``, the remaining reservation
        re-armed.  Returns the chain length, or None when the pool cannot
        cover the blocks and the reservation now.  Imported blocks are not
        fresh: their scale rows arrive in the payload."""
        if slot in self._slots:
            raise ValueError(f"slot {slot} already has an allocation")
        if int(record.get("block_len", self.block_len)) != self.block_len:
            raise ValueError(
                f"block_len mismatch: record has "
                f"{record.get('block_len')}, pool has {self.block_len}")
        entries = record["entries"]
        reserved = int(record["reserved_left"])
        if self._available() < len(entries) + reserved:
            return None
        chain: List[int] = []
        for e in entries:
            bid = self._pop_block()
            self._ref[bid] = 1
            self._dtype[bid] = 1 if e["dtype"] == "int8" else 0
            write_payload(int(bid), e["payload"])
            chain.append(bid)
        self._slots[slot] = _SlotAlloc(chain, reserved)
        self._reserved += reserved
        self._counters["imported_blocks"].inc(len(chain))
        self._note_peak()
        self._refresh_gauges()
        return len(chain)

    def preempt_free(self, slot: int):
        """Recompute-mode preemption: :meth:`release` — registered prompt
        blocks park on the LRU, so the victim's re-prefill adopts whatever
        survives the pressure through the trie (or the host tier)."""
        self.release(slot)

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
        used = self._refresh_gauges()
        if used > self._peak:
            self._peak = used
            self._g_peak.set(used)

    def _refresh_gauges(self) -> int:
        """Push the pool gauges; returns blocks_in_use."""
        used = self.blocks_in_use()
        self._g_in_use.set(used)
        self._g_occ.set(used / self.usable_blocks)
        self._g_free.set(len(self._free))
        self._g_cached.set(len(self._lru))
        live = self._live_mask()
        n_int8 = int((live & (self._dtype == 1)).sum())
        self._g_quant.set(n_int8)
        if self._host is not None:
            self._g_host_used.set(self._host.used)
            self._g_host_trie.set(len(self._host_trie))
        if self._block_nbytes:
            self._g_bytes["int8"].set(
                n_int8 * self._block_nbytes.get("int8", 0))
            self._g_bytes["bf16"].set(
                (int(live.sum()) - n_int8)
                * self._block_nbytes.get("bf16", 0))
        return used
