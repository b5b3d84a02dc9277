"""The port's BlockManager (``paddle_tpu_torch/serving/kv_cache.py``)
against the JAX package's, on the CPU.

1. Replay: one seeded random sequence of admissions (prompts drawn from a
   few shared prefixes, so the trie adopts, revives and evicts), chain
   growth, copy-on-write and releases under a tight pool goes through both
   managers; every op's result, every live slot's table row and the
   ``stats`` counters must be equal after every op.
2. The bf16, host-tier-free part of the interleaving checker of
   ``tests/test_kv_cache_model.py``: all interleavings of {admit, grow,
   COW, evict, release} to depth 8 (the reference sweeps a larger
   alphabet to depth 6) on a 4-block pool against an
   independent reference model of the documented semantics, with the
   allocator's invariants asserted at every state (chunked admission is
   replayed in section 1, rollback in section 4, the demotion and tiering
   ops of the reference's alphabet against the JAX manager in section
   5).
3. The directed scenarios of that checker (eviction cascade, COW
   overdraw, null-block table guard) and the former stubs of the tiers,
   each a working call against the JAX manager's.
4. ``truncate_to``, the speculative rollback: section 1's replay with
   rollbacks at random positions mixed in, the chains, refcounts, free
   list, LRU, trie and reservations equal to the JAX manager's after every
   op (exact), and a directed case (shared blocks past the cut survive for
   their other owner, the cut's block leaves the trie, the reservation is
   re-credited).

5. The memory tiers: section 1's replay with swap-out, resume, dropped
   swap records, recompute preemption and export / import mixed in, on a
   bf16, mixed or int8 pool with a host tier of a few blocks; the dtype
   tags, the host trie, the host ids and the hooks' calls equal the JAX
   manager's after every op.

Chunked admission (``admit(chunked=True)`` and ``register_prompt_upto``)
is replayed against the JAX manager in section 1, with the pool's
invariants checked after every op.
"""

import numpy as np
import pytest

from paddle_tpu.serving.kv_cache import BlockManager as JaxBlockManager

from paddle_tpu_torch.serving.kv_cache import NULL_BLOCK, BlockManager

STATS = ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens",
         "evictions", "cow_copies", "peak_blocks_in_use")
TIER_STATS = STATS + ("quantized_blocks", "host_demotions",
                      "host_promotions", "swapped_out_blocks",
                      "swapped_in_blocks", "exported_blocks",
                      "imported_blocks")


@pytest.fixture(autouse=True)
def _throwaway_registries(monkeypatch):
    """Each pool reports into a registry of its own: the model checker
    builds thousands of short-lived pools, and one shared registry would
    coalesce their ``pool=<id>`` series past FLAGS_metrics_max_children
    into one ``{overflow="true"}`` child (the reference's model checker
    does the same, ``tests/test_kv_cache_model.py``)."""
    from paddle_tpu_torch.observability import metrics as _metrics
    monkeypatch.setattr(_metrics, "default_registry",
                        lambda: _metrics.MetricsRegistry())


# ---- 1. replay against the JAX BlockManager ------------------------------------

def _random_ops(seed, n_ops, n_slots, bl):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, 50, 3 * bl)) for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["admit", "admit", "grow", "cow", "release"])
        slot = int(rng.integers(0, n_slots))
        if kind == "admit":
            pre = prefixes[int(rng.integers(0, 3))]
            pre = pre[:int(rng.integers(0, 3 * bl + 1))]
            tail = list(rng.integers(0, 50, int(rng.integers(1, 2 * bl))))
            ops.append(("admit", slot, pre + tail,
                        int(rng.integers(1, 2 * bl))))
        elif kind == "grow":
            ops.append(("grow", slot, int(rng.integers(0, 3 * bl))))
        elif kind == "cow":
            ops.append(("cow", slot, int(rng.integers(0, 3))))
        else:
            ops.append(("release", slot))
    return ops


def _apply(mgr, op, live):
    """Apply one op where it is legal for the manager's state (the same
    decision for both managers, which must be in the same state); returns
    the op's result."""
    kind, slot = op[0], op[1]
    if kind == "admit":
        if slot in live:
            return "skip"
        _, _, prompt, max_new = op
        return mgr.admit(slot, prompt, len(prompt), max_new)
    if slot not in live:
        return "skip"
    if kind == "grow":
        chain = mgr.chain(slot)
        pos = min(len(chain) * mgr.block_len - 1 + op[2],
                  live[slot] - 1)               # within the reservation
        return mgr.ensure_capacity(slot, pos)
    if kind == "cow":
        if op[2] >= len(mgr.chain(slot)) or not (
                mgr.free_blocks() or mgr.cached_blocks()):
            return "skip"
        return mgr.ensure_writable(slot, op[2])
    mgr.release(slot)
    return None


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix", "no_prefix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_matches_jax_block_manager(seed, prefix_cache):
    bl, nb, n_slots, max_blocks = 4, 14, 4, 16
    port = BlockManager(nb, bl, prefix_cache=prefix_cache)
    ref = JaxBlockManager(nb, bl, prefix_cache=prefix_cache)
    live = {}                        # slot -> last position it may write
    for i, op in enumerate(_random_ops(seed, 300, n_slots, bl)):
        got, want = _apply(port, op, live), _apply(ref, op, live)
        assert got == want, (i, op, got, want)
        if op[0] == "admit" and got not in ("skip", None):
            live[op[1]] = len(op[2]) + op[3]
        elif op[0] == "release" and got != "skip":
            del live[op[1]]
        for s in live:
            np.testing.assert_array_equal(port.table_row(s, max_blocks),
                                          ref.table_row(s, max_blocks))
        assert ({k: port.stats[k] for k in STATS + ("quantized_blocks",)}
                == {k: ref.stats[k] for k in STATS + ("quantized_blocks",)}), i
        assert (port.free_blocks(), port.cached_blocks(),
                port.blocks_in_use()) == (ref.free_blocks(),
                                          ref.cached_blocks(),
                                          ref.blocks_in_use()), i
    # the sequence reached every path it claims to exercise
    if prefix_cache:
        assert port.stats["prefix_hit_blocks"] > 0
        assert port.stats["evictions"] > 0
    assert port.stats["cow_copies"] > 0 or not prefix_cache


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_replay_matches_jax_block_manager(seed):
    """The int8 pool's bookkeeping against the JAX one over the same
    random ops: the blocks new to a chain (``drain_fresh``, whose scale
    rows the engine zeroes; COW destinations excluded) and
    ``quantized_blocks`` after every op."""
    bl, nb, n_slots = 4, 14, 4
    port = BlockManager(nb, bl, kv_dtype="int8")
    ref = JaxBlockManager(nb, bl, kv_dtype="int8")
    port.set_block_nbytes({"bf16": 8, "int8": 5})
    live = {}
    for i, op in enumerate(_random_ops(seed, 300, n_slots, bl)):
        got, want = _apply(port, op, live), _apply(ref, op, live)
        assert got == want, (i, op, got, want)
        if op[0] == "admit" and got not in ("skip", None):
            live[op[1]] = len(op[2]) + op[3]
        elif op[0] == "release" and got != "skip":
            del live[op[1]]
        assert port.drain_fresh() == ref.drain_fresh(), i
        q = port.stats["quantized_blocks"]
        assert q == ref.stats["quantized_blocks"], i
        assert port.stats["bytes_by_dtype"] == {"bf16": 0, "int8": 5 * q}
    assert port.stats["cow_copies"] > 0 and port.stats["evictions"] > 0


def _pool_invariants(mgr, cursors, ctx, held=()):
    """The allocator's invariants, the chunked contract's among them:
    the usable pool is partitioned into free, referenced and LRU blocks;
    refcounts are the live chains'; the trie is a bijection whose blocks
    are never free; the reservation ledger adds up; and a prefilling
    slot has no block past its cursor registered (``cursors``: slot ->
    prompt tokens written)."""
    usable = set(range(1, mgr.num_blocks))
    free, lru = set(mgr._free), set(mgr._lru)
    ref = {b for b in usable if mgr._ref[b] > 0}
    assert free | ref | lru == usable and not (free & ref), ctx
    assert not (free & lru) and not (ref & lru), ctx
    counts = np.zeros(mgr.num_blocks, np.int64)
    for st in mgr._slots.values():
        for bid in st.chain:
            counts[bid] += 1
    for bid in held:                  # references swap records keep
        counts[bid] += 1
    assert (counts == mgr._ref).all(), ctx
    assert mgr._trie == {k: b for b, k in mgr._block_key.items()}, ctx
    assert not (set(mgr._block_key) & free), ctx
    assert mgr._reserved == sum(st.reserved_left
                                for st in mgr._slots.values()) >= 0, ctx
    for slot, cur in cursors.items():
        chain = mgr.chain(slot)
        written = cur // mgr.block_len
        # blocks past the written full ones are private to the slot
        for bid in chain[written:]:
            assert bid not in mgr._block_key, ctx
            assert mgr._ref[bid] == 1, ctx


def _random_chunked_ops(seed, n_ops, n_slots, bl):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, 50, 3 * bl)) for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["admit", "chunk", "chunk", "chunk", "grow",
                           "release"])
        slot = int(rng.integers(0, n_slots))
        if kind == "admit":
            pre = prefixes[int(rng.integers(0, 3))]
            pre = pre[:int(rng.integers(0, 3 * bl + 1))]
            tail = list(rng.integers(0, 50, int(rng.integers(1, 2 * bl))))
            ops.append(("admit", slot, pre + tail,
                        int(rng.integers(1, 2 * bl))))
        elif kind == "chunk":
            ops.append(("chunk", slot, int(rng.integers(1, 2 * bl))))
        elif kind == "grow":
            ops.append(("grow", slot, int(rng.integers(0, 2 * bl))))
        else:
            ops.append(("release", slot))
    return ops


def _apply_chunked(mgr, op, live):
    """One op of the chunked engine's flow where it is legal (``live``:
    slot -> [prompt, cursor, last writable position]): admission with
    ``chunked=True``, a chunk (grow over its real tokens, then register
    the written prefix), a decode write past a finished prompt, a
    release."""
    kind, slot = op[0], op[1]
    if kind == "admit":
        if slot in live:
            return "skip"
        _, _, prompt, max_new = op
        m = mgr.admit(slot, prompt, len(prompt), max_new, chunked=True)
        if m is not None:
            live[slot] = [prompt, m, len(prompt) + max_new - 1]
        return m
    if slot not in live:
        return "skip"
    prompt, cur, last = live[slot]
    if kind == "chunk":
        if cur >= len(prompt):
            return "skip"
        clen = min(op[2], len(prompt) - cur)
        grew = mgr.ensure_capacity(slot, cur + clen - 1)
        live[slot][1] = cur + clen
        mgr.register_prompt_upto(slot, prompt, cur + clen)
        return grew
    if kind == "grow":
        if cur < len(prompt):
            return "skip"
        return mgr.ensure_capacity(slot, min(len(prompt) + op[2], last))
    mgr.release(slot)
    del live[slot]
    return None


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix", "no_prefix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_replay_matches_jax_block_manager(seed, prefix_cache):
    """Chunked admission (``admit(chunked=True)``: only the adopted prefix
    allocated, nothing registered) and per-chunk registration
    (``register_prompt_upto`` after each chunk) replayed against the JAX
    BlockManager: every op's result, every live table row, the counters
    and the invariants (:func:`_pool_invariants`) after every op."""
    bl, nb, n_slots, max_blocks = 4, 14, 4, 16
    port = BlockManager(nb, bl, prefix_cache=prefix_cache)
    ref = JaxBlockManager(nb, bl, prefix_cache=prefix_cache)
    live_p, live_r = {}, {}
    for i, op in enumerate(_random_chunked_ops(seed, 400, n_slots, bl)):
        got = _apply_chunked(port, op, live_p)
        want = _apply_chunked(ref, op, live_r)
        assert got == want, (i, op, got, want)
        for s in live_p:
            np.testing.assert_array_equal(port.table_row(s, max_blocks),
                                          ref.table_row(s, max_blocks))
        assert ({k: port.stats[k] for k in STATS}
                == {k: ref.stats[k] for k in STATS}), i
        assert (port.free_blocks(), port.cached_blocks(),
                port.blocks_in_use()) == (ref.free_blocks(),
                                          ref.cached_blocks(),
                                          ref.blocks_in_use()), i
        _pool_invariants(port, {s: v[1] for s, v in live_p.items()
                                if v[1] < len(v[0])}, (i, op))
    if prefix_cache:
        assert port.stats["prefix_hit_blocks"] > 0
        assert port.stats["evictions"] > 0


def test_chunked_admission_registers_only_written_blocks():
    """A block never satisfies a lookup before the chunk writing it is
    registered: a second admission of the same prompt adopts nothing
    while the first is mid-prompt, then the written full blocks."""
    mgr = BlockManager(12, 4)
    prompt = list(range(1, 14))                          # 13 tokens
    assert mgr.admit(0, prompt, 13, 2, chunked=True) == 0
    assert mgr.chain(0) == []                            # nothing allocated
    mgr.ensure_capacity(0, 5)                            # chunk of 6 tokens
    assert mgr.admit(1, prompt, 13, 2, chunked=True) == 0   # not yet
    mgr.register_prompt_upto(0, prompt, 6)               # block 0 written
    mgr.release(1)
    assert mgr.admit(1, prompt, 13, 2, chunked=True) == 4
    assert mgr.chain(1) == mgr.chain(0)[:1]
    mgr.ensure_capacity(0, 12)
    mgr.register_prompt_upto(0, prompt, 13)              # blocks 1, 2 too
    mgr.register_prompt_upto(0, prompt, 13)              # idempotent
    assert len(mgr._trie) == 3


# ---- 2. the interleaving checker (bf16, no host tier) ---------------------------

BL = 2            # tokens per block
NUM_BLOCKS = 5    # 4 usable + the null block
DEPTH = 8
_ROOT_PATH = ()

# slot -> (prompt, prompt_len, max_new): slot 0 registers block (1, 2) and
# keeps 1 reserved; slot 1 shares it when registered (adoption + COW
# material); slot 3's five-token prompt registers two trie levels and is
# admitted only under pool pressure (the eviction-cascade probe)
SLOT_CFG = {
    0: ((1, 2, 3), 3, 2),
    1: ((1, 2, 9), 3, 1),
    3: ((11, 12, 13, 14, 15), 5, 1),
}


class _Entry:
    __slots__ = ("refs", "path")

    def __init__(self):
        self.refs = 0
        self.path = None


class RefPool:
    """Reference model of the documented BlockManager semantics over
    abstract entries (trie identity = token path)."""

    def __init__(self):
        self.free = NUM_BLOCKS - 1
        self.reserved = 0
        self.slots = {}            # slot -> {"chain": [...], "left": int}
        self.registered = {}       # path -> _Entry
        self.lru = []              # refcount-0 registered entries, LRU order
        self.evictions = 0
        self.cow_copies = 0
        self.hit_tokens = 0

    def live_entries(self):
        seen = []
        for st in self.slots.values():
            for e in st["chain"]:
                if e not in seen:
                    seen.append(e)
        return seen

    def available(self):
        return self.free + len(self.lru) - self.reserved

    def pool_nonempty(self):
        return self.free > 0 or len(self.lru) > 0

    def _pop_block(self):
        if self.free > 0:
            self.free -= 1
            return _Entry()
        e = self.lru.pop(0)
        self.evictions += 1
        self._unregister_cascade(e)
        return e

    def _unregister_cascade(self, root):
        prefix = root.path
        for path in [p for p in self.registered
                     if p[:len(prefix)] == prefix]:
            e = self.registered.pop(path)
            e.path = None
            if e is not root and e in self.lru:
                self.lru.remove(e)
                self.free += 1

    def _append_block(self, slot):
        st = self.slots[slot]
        assert st["left"] > 0, "model bug: growth past reservation"
        e = self._pop_block()
        e.refs = 1
        st["chain"].append(e)
        st["left"] -= 1
        self.reserved -= 1

    def admit(self, slot):
        prompt, plen, max_new = SLOT_CFG[slot]
        matched = []
        parent = _ROOT_PATH
        for b in range((plen - 1) // BL):
            path = parent + (tuple(prompt[b * BL:(b + 1) * BL]),)
            e = self.registered.get(path)
            if e is None:
                break
            matched.append(e)
            parent = path
        need = -(-(plen + max_new) // BL) - len(matched)
        if self.available() - sum(e.refs == 0 for e in matched) < need:
            return None
        for e in matched:
            if e.refs == 0:
                self.lru.remove(e)
            e.refs += 1
        self.slots[slot] = {"chain": list(matched), "left": need}
        self.reserved += need
        for _ in range(plen // BL + 1 - len(matched)):
            self._append_block(slot)
        chain = self.slots[slot]["chain"]
        parent = _ROOT_PATH
        for b in range(plen // BL):
            path = parent + (tuple(prompt[b * BL:(b + 1) * BL]),)
            if path not in self.registered and chain[b].path is None:
                self.registered[path] = chain[b]
                chain[b].path = path
            parent = path
        self.hit_tokens += len(matched) * BL
        return len(matched) * BL

    def ensure_capacity(self, slot, pos):
        st = self.slots[slot]
        grew = False
        while len(st["chain"]) * BL <= pos:
            self._append_block(slot)
            grew = True
        return grew

    def cow_write(self, slot, lb):
        st = self.slots[slot]
        e = st["chain"][lb]
        if e.refs <= 1:
            return False
        dst = self._pop_block()
        e.refs -= 1
        dst.refs = 1
        st["chain"][lb] = dst
        self.cow_copies += 1
        return True

    def release(self, slot):
        st = self.slots.pop(slot)
        self.reserved -= st["left"]
        for e in st["chain"]:
            e.refs -= 1
            if e.refs == 0:
                if e.path is not None:
                    self.lru.append(e)
                else:
                    self.free += 1


def _growable(model):
    for s in sorted(model.slots):
        if model.slots[s]["left"] > 0:
            return s
    return None


def _mk_admit(s):
    def _apply_admit(mgr, model):
        p, plen, mn = SLOT_CFG[s]
        return mgr.admit(s, list(p), plen, mn), model.admit(s)
    return _apply_admit


def _op_grow(mgr, model):
    s = _growable(model)
    pos = len(model.slots[s]["chain"]) * BL
    return mgr.ensure_capacity(s, pos), model.ensure_capacity(s, pos)


def _op_cow(mgr, model):
    return mgr.ensure_writable(1, 0) is not None, model.cow_write(1, 0)


def _op_release(mgr, model):
    s = max(model.slots)
    return mgr.release(s), model.release(s)


def _cow_enabled(m):
    if 1 not in m.slots or not m.slots[1]["chain"]:
        return False
    # COW draws outside the reservation: on an empty pool the manager
    # raises, so keep the sweep total
    return m.slots[1]["chain"][0].refs <= 1 or m.pool_nonempty()


OPS = [
    ("admit:0", lambda m: 0 not in m.slots, _mk_admit(0)),
    ("admit:1", lambda m: 1 not in m.slots, _mk_admit(1)),
    ("ensure_capacity",
     lambda m: _growable(m) is not None and m.pool_nonempty(), _op_grow),
    ("cow_write", _cow_enabled, _op_cow),
    ("evict", lambda m: 3 not in m.slots and len(m.lru) > 0, _mk_admit(3)),
    ("release", lambda m: len(m.slots) > 0, _op_release),
]
_OP_BY_NAME = {name: (name, en, ap) for name, en, ap in OPS}


def _check(mgr, model, trace):
    ctx = f"after {' -> '.join(trace)}"
    usable = set(range(1, NUM_BLOCKS))
    free, lru = set(mgr._free), set(mgr._lru)
    ref = {b for b in usable if mgr._ref[b] > 0}
    # I1: partition of the usable pool; the null block in none of them
    assert free | ref | lru == usable, ctx
    assert not (free & ref) and not (free & lru) and not (ref & lru), ctx
    assert NULL_BLOCK not in free | ref | lru, ctx
    # I2: refcounts match the live chains
    counts = np.zeros(NUM_BLOCKS, np.int64)
    for st in mgr._slots.values():
        for bid in st.chain:
            counts[bid] += 1
    assert (counts == mgr._ref).all(), ctx
    # I3: trie bijection, children links, registered blocks never free
    assert mgr._trie == {k: b for b, k in mgr._block_key.items()}, ctx
    for b, key in mgr._block_key.items():
        assert b not in free, ctx
        if key[0] != -1:
            assert b in mgr._children.get(key[0], set()), ctx
    # I4: reservation ledger
    assert mgr._reserved == sum(st.reserved_left
                                for st in mgr._slots.values()), ctx
    # I6: null-block aliasing + table_row round trip
    for slot, st in mgr._slots.items():
        assert NULL_BLOCK not in st.chain, ctx
        row = mgr.table_row(slot, 8)
        assert list(row[:len(st.chain)]) == st.chain, ctx
        assert (row[len(st.chain):] == NULL_BLOCK).all(), ctx
    # agreement with the model on everything the engine observes
    assert mgr.free_blocks() == model.free, ctx
    assert mgr.cached_blocks() == len(model.lru), ctx
    assert mgr.blocks_in_use() == len(model.live_entries()), ctx
    assert mgr._reserved == model.reserved, ctx
    assert sorted(mgr._slots) == sorted(model.slots), ctx
    for slot, st in mgr._slots.items():
        mst = model.slots[slot]
        assert len(st.chain) == len(mst["chain"]), ctx
        assert st.reserved_left == mst["left"], ctx
        assert ([int(mgr._ref[b]) for b in st.chain]
                == [e.refs for e in mst["chain"]]), ctx
    assert len(mgr._trie) == len(model.registered), ctx
    assert mgr.stats["evictions"] == model.evictions, ctx
    assert mgr.stats["cow_copies"] == model.cow_copies, ctx
    assert mgr.stats["prefix_hit_tokens"] == model.hit_tokens, ctx


def _replay(ops, check_every=True):
    mgr, model = BlockManager(NUM_BLOCKS, BL), RefPool()
    trace = []
    for i, (name, _, apply) in enumerate(ops):
        trace.append(name)
        real, ref = apply(mgr, model)
        assert real == ref, (f"op result drift after {' -> '.join(trace)}: "
                             f"real={real!r} model={ref!r}")
        if check_every or i == len(ops) - 1:
            _check(mgr, model, trace)
    return mgr, model


def test_exhaustive_interleavings_bf16():
    """All enabled-op interleavings to depth 8, the invariants at every
    state (each proper prefix is itself a visited node), against the
    reference model; every op of the alphabet is reached."""
    explored, hit = [0], set()

    def dfs(prefix):
        _, model = _replay(prefix, check_every=False)
        explored[0] += 1
        if len(prefix) == DEPTH:
            return
        for op in OPS:
            if op[1](model):
                hit.add(op[0])
                dfs(prefix + [op])

    dfs([])
    assert explored[0] > 3000, explored[0]
    assert hit == set(_OP_BY_NAME)


# ---- 3. directed scenarios + unported items ------------------------------------

def test_eviction_cascade_with_descendants():
    """Slot 3's prompt registers a parent + child chain; after release
    both park on the LRU; admitting under pressure evicts the parent and
    the cascade frees the parked child too (a stale child entry would
    serve a prefix hit for blocks whose parent id was reused)."""
    trace = []
    mgr, model = BlockManager(NUM_BLOCKS, BL), RefPool()
    for name in ["evict", "release", "admit:0", "admit:1"]:
        trace.append(name)
        _, _, apply = _OP_BY_NAME[name]
        real, ref = apply(mgr, model)
        assert real == ref, trace
        _check(mgr, model, trace)
    assert mgr.stats["evictions"] == 1
    assert mgr.cached_blocks() == 0
    assert len(mgr._trie) == 1          # only slot 0/1's shared (1, 2)


def test_cow_overdraw_then_reserved_growth_exhausts_pool():
    """COW is not covered by the admission reservation: a fork on a full
    pool takes the block a reservation counted on, and the next reserved
    growth raises instead of corrupting a chain."""
    mgr = BlockManager(NUM_BLOCKS, BL)
    assert mgr.admit(0, [1, 2, 3], 3, 2) == 0       # 2 blocks + 1 reserved
    assert mgr.admit(1, [1, 2, 9], 3, 1) == 2       # adopts the (1,2) block
    assert mgr.ensure_writable(1, 0) is not None    # COW takes the last block
    assert mgr.free_blocks() == 0 and mgr.cached_blocks() == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        mgr.ensure_capacity(0, 4)
    assert len(mgr.chain(0)) == 2 and mgr._reserved == 1


def test_table_row_rejects_null_block_in_live_chain():
    mgr = BlockManager(NUM_BLOCKS, BL)
    assert mgr.admit(0, [1, 2, 3], 3, 1) == 0
    mgr._slots[0].chain[0] = NULL_BLOCK     # simulate the corruption
    with pytest.raises(AssertionError, match="null block"):
        mgr.table_row(0, 8)


def test_unported_items_raise():
    """The host tier (ROADMAP A3) and the mixed pool (A2) are ported: both
    managers build, and each former stub is a working call — swap_out,
    resume_swapped, export_blocks, import_blocks, preempt_free — with the
    same results, hook calls and dtype tags as the JAX manager's."""
    seen = []
    for cls in (BlockManager, JaxBlockManager):
        mgr = cls(5, 2, host_blocks=3, kv_dtype="mixed")
        calls = []
        mgr.on_demote = lambda b, c=calls: c.append(("demote", list(b)))
        mgr.on_swap_out = lambda p, c=calls: c.append(("out", list(p)))
        mgr.on_swap_in = lambda p, c=calls: c.append(("in", list(p)))
        out = [mgr.admit(0, [1, 2, 3], 3, 1)]
        rec = mgr.swap_out(0)
        out += [rec, mgr.host_blocks_used(), mgr.blocks_in_use()]
        out += [mgr.resume_swapped(0, rec), mgr.chain(0),
                [mgr.block_dtype(b) for b in mgr.chain(0)]]
        exp = mgr.export_blocks(0, lambda bid: ("payload", bid))
        out += [exp]
        mgr.preempt_free(0)
        out += [mgr.blocks_in_use(), mgr.cached_blocks()]
        written = []
        out += [mgr.import_blocks(1, exp,
                                  lambda bid, p: written.append((bid, p))),
                written, mgr.chain(1),
                [mgr.block_dtype(b) for b in mgr.chain(1)]]
        out += [{k: mgr.stats[k] for k in TIER_STATS}]
        seen.append((out, calls))
    assert seen[0] == seen[1]
    out, calls = seen[0]
    assert out[0] == 0 and out[2] == 2 and out[3] == 0
    assert ("demote", [1]) in calls and out[6] == ["int8", "bf16"]


# ---- 4. truncate_to (speculative rollback) against the JAX BlockManager ----

def _state(mgr, n_slots, max_blocks):
    """Everything truncate_to touches: chains (table rows), refcounts, the
    free list in order, the trie, the reservations, the counters."""
    return {"tables": {s: mgr.table_row(s, max_blocks).tolist()
                       for s in range(n_slots) if s in mgr._slots},
            "ref": mgr._ref.tolist(), "free": list(mgr._free),
            "lru": list(mgr._lru), "trie": dict(mgr._trie),
            "reserved": mgr._reserved,
            "reserved_left": {s: st.reserved_left
                              for s, st in mgr._slots.items()},
            "stats": {k: mgr.stats[k] for k in STATS}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncate_replay_matches_jax_block_manager(seed):
    """The replay of section 1 with rollbacks mixed in: after every op —
    admissions that adopt shared prefixes, growth, copy-on-write,
    ``truncate_to`` at any position of a chain (inside a block, at a
    boundary, below registered prompt blocks), releases — the chains,
    refcounts, free list, LRU, trie and reservations equal the JAX
    manager's, and the pool's invariants hold."""
    bl, nb, n_slots, max_blocks = 4, 14, 4, 16
    port = BlockManager(nb, bl)
    ref = JaxBlockManager(nb, bl)
    rng = np.random.default_rng(100 + seed)
    live = {}
    truncated = 0
    for i, op in enumerate(_random_ops(seed, 300, n_slots, bl)):
        if rng.random() < 0.3 and op[1] in live:
            cover = len(port.chain(op[1])) * bl
            pos = int(rng.integers(0, cover + 1))
            got = port.truncate_to(op[1], pos)
            want = ref.truncate_to(op[1], pos)
            truncated += 1
        else:
            got, want = _apply(port, op, live), _apply(ref, op, live)
            if op[0] == "admit" and got not in ("skip", None):
                live[op[1]] = len(op[2]) + op[3]
            elif op[0] == "release" and got != "skip":
                del live[op[1]]
        assert got == want, (i, op, got, want)
        assert _state(port, n_slots, max_blocks) == _state(
            ref, n_slots, max_blocks), i
        _pool_invariants(port, {}, i)
    assert truncated > 30 and port.stats["prefix_hit_blocks"] > 0


def test_truncate_unregisters_from_the_cut_and_spares_shared_blocks():
    """Directed: a chain adopted by a second slot keeps its shared blocks
    when the first slot rolls back past them (deref, not free); the block
    at the cut and every later registered block leave the trie (with
    their cached descendants); the released blocks are re-credited to the
    slot's reservation, so it can grow over the same positions again."""
    bl = 2
    for mgr in (BlockManager(12, bl), JaxBlockManager(12, bl)):
        prompt = [1, 2, 3, 4, 5, 6, 7]
        assert mgr.admit(0, prompt, 7, 4) == 0            # 4 blocks
        assert mgr.admit(1, prompt, 7, 4) == 6            # adopts 3
        shared = mgr.chain(0)[:3]
        assert mgr.chain(1)[:3] == shared
        left0 = mgr._slots[0].reserved_left
        mgr.ensure_capacity(0, 9)                          # 5 blocks
        mgr.truncate_to(0, 3)                              # keep 2 blocks
        assert mgr.chain(0) == shared[:2]
        # the shared third block survives for slot 1, unregistered
        assert mgr._ref[shared[2]] == 1 and shared[2] not in mgr._free
        # the cut's block (positions 2-3, rewritten from 3 on) and its
        # descendant leave the trie; the block below the cut stays
        assert shared[1] not in mgr._block_key
        assert shared[2] not in mgr._block_key
        assert shared[0] in mgr._block_key
        assert mgr._slots[0].reserved_left == left0 + 2
        mgr.ensure_capacity(0, 10)                         # regrow
        assert len(mgr.chain(0)) == 6
        mgr.truncate_to(0, 12)                             # no-op
        assert len(mgr.chain(0)) == 6
        with pytest.raises(ValueError, match="pos must be"):
            mgr.truncate_to(0, -1)
        mgr.release(0)
        mgr.release(1)
        assert mgr.blocks_in_use() == 0


# ---- 5. the memory tiers against the JAX BlockManager --------------------------

def _tier_state(mgr, n_slots, max_blocks):
    """Everything the tiers touch, beside section 4's state: the dtype tags,
    the host trie (path -> host id, dtype), the live host ids, the device
    blocks' token paths and every counter."""
    host = mgr.host_tier
    return {**_state(mgr, n_slots, max_blocks),
            "dtype": mgr._dtype.tolist(),
            "host_trie": list(mgr._host_trie.items()),
            "host_live": sorted(host._live) if host is not None else None,
            "block_path": dict(mgr._block_path),
            "stats": {k: mgr.stats[k] for k in TIER_STATS}}


def _tier_ops(seed, n_ops, n_slots, bl):
    """Section 1's ops plus the tiers' alphabet: swap-out of a live slot,
    resume of a parked record into a free slot, drop of a parked record,
    recompute preemption, and export of a live slot with its import into
    a free one."""
    rng = np.random.default_rng(seed)
    base = _random_ops(seed, n_ops, n_slots, bl)
    ops = []
    for op in base:
        r = rng.random()
        slot = int(rng.integers(0, n_slots))
        if r < 0.12:
            ops.append(("swap", slot))
        elif r < 0.24:
            ops.append(("resume", slot, int(rng.integers(0, 4))))
        elif r < 0.28:
            ops.append(("drop", int(rng.integers(0, 4))))
        elif r < 0.34:
            ops.append(("preempt", slot))
        elif r < 0.40:
            ops.append(("export", slot, int(rng.integers(0, n_slots))))
        else:
            ops.append(op)
    return ops


def _apply_tier(mgr, op, live, parked):
    """One op where it is legal (``live``: slot -> last writable position;
    ``parked``: swap records awaiting resume, with that position)."""
    kind = op[0]
    if kind == "swap":
        if op[1] not in live:
            return "skip"
        rec = mgr.swap_out(op[1])
        if rec is not None:
            parked.append((rec, live.pop(op[1])))
        return rec
    if kind == "resume":
        if op[1] in live or not parked:
            return "skip"
        rec, last = parked[op[2] % len(parked)]
        got = mgr.resume_swapped(op[1], rec)
        if got is not None:
            parked.remove((rec, last))
            live[op[1]] = last
        return got
    if kind == "drop":
        if not parked:
            return "skip"
        rec, last = parked.pop(op[1] % len(parked))
        mgr.drop_swap_record(rec)
        return None
    if kind == "preempt":
        if op[1] not in live:
            return "skip"
        mgr.preempt_free(op[1])
        del live[op[1]]
        return None
    if kind == "export":
        src, dst = op[1], op[2]
        if src not in live or dst in live:
            return "skip"
        rec = mgr.export_blocks(src, lambda bid: bid)
        written = []
        got = mgr.import_blocks(dst, rec,
                                lambda bid, p: written.append((bid, p)))
        if got is not None:
            live[dst] = live[src]
        return rec, got, written
    return _apply(mgr, op, live)


@pytest.mark.parametrize("kv_dtype,host_blocks", [
    ("bf16", 3), ("mixed", 3), ("mixed", 0), ("int8", 4)])
@pytest.mark.parametrize("seed", [0, 2])
def test_tier_replay_matches_jax_block_manager(seed, kv_dtype, host_blocks):
    """Section 1's replay with the tiers' ops mixed in, on a mixed, bf16
    or int8 pool with a host tier of a few blocks (so swap records and
    demoted prefix blocks compete for it): after every op the results, the
    hooks' calls (demotions, swap-outs, swap-ins, in order), the chains,
    refcounts, free list, LRU, trie, reservations, dtype tags, host trie
    and host ids equal the JAX manager's, and the pool's invariants
    hold."""
    bl, nb, n_slots, max_blocks = 4, 14, 4, 16
    mgrs = [cls(nb, bl, kv_dtype=kv_dtype, host_blocks=host_blocks)
            for cls in (BlockManager, JaxBlockManager)]
    calls = [[], []]
    for mgr, c in zip(mgrs, calls):
        mgr.set_block_nbytes({"bf16": 8, "int8": 5})
        mgr.on_demote = lambda b, c=c: c.append(("demote", list(b)))
        mgr.on_swap_out = lambda p, c=c: c.append(("out", list(p)))
        mgr.on_swap_in = lambda p, c=c: c.append(("in", list(p)))
    live = [{}, {}]
    parked = [[], []]
    kinds = set()
    for i, op in enumerate(_tier_ops(seed, 400, n_slots, bl)):
        got = _apply_tier(mgrs[0], op, live[0], parked[0])
        want = _apply_tier(mgrs[1], op, live[1], parked[1])
        assert got == want, (i, op, got, want)
        if got != "skip":
            kinds.add(op[0])
        if op[0] == "admit" and got not in ("skip", None):
            for lv in live:
                lv[op[1]] = len(op[2]) + op[3]
        elif op[0] == "release" and got != "skip":
            for lv in live:
                del lv[op[1]]
        assert calls[0] == calls[1], i
        assert _tier_state(mgrs[0], n_slots, max_blocks) == _tier_state(
            mgrs[1], n_slots, max_blocks), i
        assert mgrs[0].stats["bytes_by_dtype"] == {
            "bf16": 8 * (mgrs[0]._live_mask().sum()
                         - mgrs[0].quantized_blocks()),
            "int8": 5 * mgrs[0].quantized_blocks()}, i
        assert (mgrs[0].host_blocks_used(), mgrs[0].host_trie_blocks(),
                mgrs[0].host_cache_bytes()) == (
            mgrs[1].host_blocks_used(), mgrs[1].host_trie_blocks(),
            mgrs[1].host_cache_bytes()), i
        _pool_invariants(mgrs[0], {}, i, held=[
            e[1] for rec, _ in parked[0] for e in rec["entries"]
            if e[0] == "hbm"])
    port = mgrs[0]
    assert {"swap", "export", "preempt"} <= kinds, kinds
    if kv_dtype == "mixed":
        assert any(c[0] == "demote" for c in calls[0])
    if host_blocks:
        assert "resume" in kinds and port.stats["swapped_out_blocks"] > 0
        assert port.stats["host_demotions"] > 0
        assert port.stats["host_promotions"] > 0
