"""The serving engine's once-built steps (the reference's ``serving.step``
and ``serving.prefill`` sites, ``paddle_tpu/serving/engine.py:672-708``):
the decode step (:class:`DecodeStep`; the speculative engine's
:class:`VerifyStep`, its window of k + 1 tokens a row), in the chunked
engine the mixed step (:class:`MixedStep`), in the wave engines one
prefill-wave step a (bucket, rows) key (:class:`PrefillStep`), and the
draft model's two steps (:class:`DraftStep`, :class:`IngestStep`; sites
``serving.draft_step`` and ``serving.draft_prefill``).

The reference jits its step once, under ``track_retraces(...,
"serving.step", budget=1)``, and the device then runs one compiled program
a tick.  The port's counterpart is :class:`DecodeStep`: the model's
``decode_step`` over static input buffers — tokens (B, 1), positions (B,)
and, paged, the block tables (B, max_blocks), all int32 — through the
last position's logits (B, vocab) and their greedy argmax.  Its one build
is counted by the port's watchdog (``observability/watchdog.py``) under the
same site name, labelled by engine:

  * on the card: a warm-up of ``WARMUP_TICKS`` eager runs on the engine's
    own ``torch.cuda.Stream`` (kernel builds, Triton compiles, the
    kernels' first-launch attributes, the K1 merge counters: all before
    the capture), then ONE ``torch.cuda.CUDAGraph`` capture on that
    stream; every decode tick after that is one replay.  A build that
    fails raises — the engine never serves eagerly instead;
  * on the CPU, and on the card inside :func:`disable_graphs` (the port's
    ``jax.disable_jit()``): the same static-buffer step runs eagerly each
    tick.  The build only counts; no graph exists.

Inputs reach the step through one staging buffer: the engine's host
mirrors of tokens, positions and tables are numpy views of it (pinned
memory on the card), and each tick copies it to the device buffer in one
host-to-device copy.  That copy may be asynchronous because every tick
ends in the token fetch, which waits for it, before the host writes the
mirrors again.

The chunked engine (``chunked=True``) builds two: its :class:`MixedStep`
— the decode rows, then one ``prefill_chunk``-token prompt chunk, the
reference's ``_mixed_step_impl`` / ``_mixed_step_impl_paged`` (:1268,
:1310), counted under ``serving.step`` (its ``step_traces``) — and a
:class:`DecodeStep` for the ticks that carry no chunk, counted under the
same site with the label ``graph="decode"``.  The reference runs those
ticks through its one program with a dummy chunk whose writes drop; the
port replays the decode graph instead, so a chunk-free tick costs a
decode tick, not a 256-token pass.  The decode rows run the same kernels
at the same shapes in both graphs, so the tokens are those of one
program.  The two graphs share the decode rows' input buffers.

The wave engines build one :class:`PrefillStep` a (bucket, rows) key —
a wave of ``rows`` prompts padded to ``bucket`` tokens, the reference's
``_prefill_impl`` / ``_prefill_impl_paged`` (:1211, :1248), which it jits
once a bucket under ``track_retraces(..., "serving.prefill")`` — each on
its first use while the engine serves, counted under ``serving.prefill``
with budget 1 a key (labels: engine, bucket, rows).  Only a wave's real
rows run (the reference pads to ``prefill_batch`` rows), so the key
carries the row count.  A build may not write what a live request reads:
the paged warm-up and capture run on all-null tables at prefix 0 (every
write lands in the null block), the contiguous ones on the wave's own
slots, which the replay then writes again.  A capture runs nothing, so
the first use of a key uploads the real inputs and replays once more.
The prefill graphs of one engine share one memory pool: their static
outputs stay live, and the engine reads each replay's outputs before the
next replay of any of them, so one graph's scratch may reuse another's.

What the capture fixes, and so what a replay cannot see change: the
model's weights and the engine's cache (both written or read in place at
their addresses), the split length of flash-decode
(``FLAGS_decode_attention_block_kv``, read at capture), K4's K split and
tensor maps (fixed by shape and address), and which kernels run (the
route of each op at capture).  Launch counters are credited per replay
(``ops.ReplayCounts``), so ``.launches`` counts replays x launches per
graph, as an eager run of the same ticks would; the warm-up's launches
and the capture's are the build's and are taken back out.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Optional, Tuple

import torch

from .. import ops
from ..models.generation import init_kv_cache
from ..observability import track_retraces
from ..ops.cuda.decode_attention import private_counters

# eager runs before the capture: the first builds and loads every kernel;
# the second runs the step as the capture will see it
WARMUP_TICKS = 2
# a prefill key's eager runs before its capture: none.  On the H100 at the
# Llama-3-8B width every wave key of chip_smoke.py's phases 4-4d captured
# without one, its tokens equal to the eager twin's, even the first key
# of a process, whose capture builds and loads K2 (chip_prefill_waves.py
# --warmup 0/1/2); each warm-up run costs the key's first wave about an
# eager wave more.  The engine's decode step has loaded cuBLAS and K3.
PREFILL_WARMUP = 0

_disabled = False


@contextlib.contextmanager
def disable_graphs():
    """The port's ``jax.disable_jit()``: an engine that builds its decode
    step while this is open runs the step eagerly on the card — the same
    static-buffer step, one build all the same, no graph — and so do its
    prefill waves.  Read at the build, so the engine keeps its mode after
    the context closes.  For eager twins of a graphed engine
    (``chip_smoke.py``)."""
    global _disabled
    prev = _disabled
    _disabled = True
    try:
        yield
    finally:
        _disabled = prev


class _Step:
    """A step over static buffers, built once (counted under ``SITE``,
    budget 1) and run once a tick or wave; see the module docstring.
    Subclasses define :meth:`_body` (the step on the static buffers) and
    hold their inputs in ``_stage`` (pinned host staging) and ``_inputs``
    (its device buffer), which :meth:`_upload` copies.  ``eager``:
    run eagerly whatever :func:`disable_graphs` says at the build (None:
    as it says); ``pool``: the memory pool the capture shares."""

    SITE = "serving.step"
    WARMUP = WARMUP_TICKS

    def __init__(self, device: torch.device, labels: dict,
                 eager: Optional[bool] = None, pool=None):
        self.device = device
        self._graph = None
        self._out: Optional[Tuple[torch.Tensor, ...]] = None
        self._counts: Optional[ops.ReplayCounts] = None
        self._counters: dict = {}
        self._stream = None
        self._eager = eager
        self._pool = pool
        self.replays = 0
        self._tracked = track_retraces(self._build, self.SITE, budget=1,
                                       labels=labels)

    @property
    def traces(self) -> int:
        """Builds of this step (the engine's ``step_traces``, or one key's
        share of its ``prefill_traces``)."""
        return self._tracked.traces

    @property
    def graphed(self) -> bool:
        return self._graph is not None

    def build(self) -> None:
        """Build the step: counted, budget 1 (a second build is a watchdog
        violation, ``FLAGS_retrace_watchdog``).  The warm-up runs the step
        on whatever the device buffers hold after an upload of the
        staging, which must write nothing a live request reads (decode:
        idle rows, mixed: a chunk whose writes all drop; prefill: see
        :class:`PrefillStep`)."""
        self._tracked()

    def _upload(self, non_blocking: bool) -> None:
        self._inputs.copy_(self._stage, non_blocking=non_blocking)

    def _body(self) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def _build(self) -> None:
        self._graph = self._out = self._counts = None
        eager = _disabled if self._eager is None else self._eager
        if self.device.type != "cuda" or eager:
            return
        self._upload(False)
        (cap,), self._counters, self._stream = capture(
            [self._body], self.device, self.WARMUP, self._pool, self.SITE)
        self._graph, self._out, self._counts = cap

    def run(self, non_blocking: bool = True) -> Tuple[torch.Tensor, ...]:
        """One tick or wave: upload the host mirrors, then replay the graph
        (or run the step eagerly).  Returns the step's outputs on the
        device — the graph's static outputs, overwritten by the next
        replay.  ``non_blocking=False`` returns only once the upload is
        done, for a caller that writes the mirrors again before its next
        synchronisation."""
        self._upload(non_blocking)
        if self._graph is None:
            return self._body()
        self._graph.replay()
        self._counts.add()
        self.replays += 1
        return self._out


def capture(bodies, device: torch.device, warmup: int, pool=None,
            what: str = "step"):
    """Capture each of ``bodies`` (functions of no argument over static
    buffers, run under ``torch.no_grad()``) as one CUDA graph: first
    ``warmup`` eager runs of each on a stream of its own (kernel builds,
    Triton compiles, the kernels' first-launch attributes, K1's merge
    counters: all before the capture; their launches are the build's and
    are taken back out of the counters; cuBLAS's handle and workspace
    for the stream), then one capture each, the
    graphs sharing ``pool`` (or the first graph's pool).  The garbage
    collector does not run inside a capture: freeing an unreachable
    engine's graph there (a reset) invalidates the capture.  A capture
    that allocates K1 merge counters the warm-up did not raises
    (``what`` names the step).  Returns ([(graph, outputs, ReplayCounts)
    a body], the counter store, the stream): the graphs hold raw
    pointers into the store, so keep it for their life."""
    stream = torch.cuda.Stream(device=device)
    counters: dict = {}
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), private_counters(counters), \
            ops.ReplayCounts.record(), torch.no_grad():
        # cuBLAS creates its handle and this stream's workspace at its
        # first product, which a capture refuses: one small product here
        # (a body whose products are the process's first -- an int8-weight
        # engine's dequantized wave -- would otherwise fail to capture)
        eye = torch.eye(8, device=device)
        eye @ eye
        for body in bodies:
            for _ in range(warmup):
                body()
    torch.cuda.current_stream(device).wait_stream(stream)
    held = {k: t.data_ptr() for k, t in counters.items()}
    graphs = []
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        for body in bodies:
            graph = torch.cuda.CUDAGraph()
            with ops.ReplayCounts.record() as counts, \
                    private_counters(counters), torch.no_grad():
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = body()
            pool = graph.pool() if pool is None else pool
            graphs.append((graph, out, counts))
    finally:
        if collecting:
            gc.enable()
    if {k: t.data_ptr() for k, t in counters.items()} != held:
        raise RuntimeError(
            f"{what}: the capture allocated K1 merge counters the warm-up "
            f"did not; the graph would write memory it does not own")
    return graphs, counters, stream


def weights_key(model) -> int:
    """A key of where the model's weights live: the hash of the data
    pointers (and dtypes) of every parameter and buffer of the bound model
    (a decode wrapper's ``unwrapped`` model).  A captured graph reads the
    weights at these addresses, so a program is only reused while it is
    unchanged."""
    m = getattr(model, "unwrapped", model)
    return hash(tuple((t.data_ptr(), t.dtype) for t in
                      (*m.parameters(), *m.buffers())))


class ProgramCache(dict):
    """A model's once-built programs by key (``_generate_jit_cache`` of
    ``models/generation.py``, ``_ddim_jit_cache`` of
    ``models/diffusion.py``).  A copy of the model
    starts with an empty cache: a program holds its own buffers and, on
    the card, CUDA graphs over the original's weights."""

    def __deepcopy__(self, memo):
        return type(self)()


def cached_program(model, attr: str, key: tuple, make):
    """The program of ``key`` in ``model.<attr>``, made by ``make()`` and
    built on first use.  Each program records the :func:`weights_key` it
    was built over (``.weights``); the programs of other weights are
    dropped first, so a model whose tensors moved (``.to(dtype)``,
    ``.float()``) builds anew instead of replaying graphs that read freed
    memory."""
    cache = getattr(model, attr, None)
    if cache is None:
        cache = ProgramCache()
        setattr(model, attr, cache)
    w = weights_key(model)
    for k in [k for k, p in cache.items() if p.weights != w]:
        del cache[k]
    prog = cache.get(key)
    if prog is None:
        prog = cache[key] = make()
        prog.build()
    return prog


def _staging(n: int, device: torch.device):
    """(pinned host staging, its numpy view, the device buffer) of ``n``
    int32s."""
    stage = torch.zeros(n, dtype=torch.int32,
                        pin_memory=device.type == "cuda")
    return stage, stage.numpy(), torch.zeros(n, dtype=torch.int32,
                                             device=device)


def _align4(n: int) -> int:
    return -(-n // 4) * 4              # 16-byte aligned sections


class DecodeStep(_Step):
    """One engine's decode step over static buffers; see the module
    docstring.  ``tokens_host`` / ``positions_host`` / ``tables_host``
    are the engine's host mirrors (numpy views of the staging buffer);
    :meth:`build` is the counted build (budget 1), :meth:`run` one tick,
    returning (logits (B, vocab), greedy tokens (B,)).  ``graph``: an
    extra label of the build counter (the chunked engine's ``"decode"``)."""

    def __init__(self, model, cache, num_slots: int,
                 max_blocks: Optional[int], device: torch.device,
                 engine_id, graph: Optional[str] = None):
        labels = {"engine": engine_id}
        if graph is not None:
            labels["graph"] = graph
        super().__init__(device, labels)
        self._model = model
        self._cache = cache
        b = num_slots
        bp = _align4(b)
        n = 2 * bp + (b * max_blocks if max_blocks else 0)
        self._stage, host, self._inputs = _staging(n, device)
        self.tokens_host = host[:b]
        self.positions_host = host[bp:bp + b]
        self.tokens = self._inputs[:b].view(b, 1)
        self.positions = self._inputs[bp:bp + b]
        self.tables_host = self.tables = None
        if max_blocks:
            self.tables_host = host[2 * bp:].reshape(b, max_blocks)
            self.tables = self._inputs[2 * bp:].view(b, max_blocks)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = self._model.decode_step(self.tokens, self._cache,
                                            self.positions,
                                            block_tables=self.tables)
        logits = logits[:, -1]
        return logits, logits.argmax(dim=-1)


class VerifyStep(DecodeStep):
    """The speculative engine's verify step: :class:`DecodeStep`'s static
    staging with a window of ``window`` = k + 1 tokens a row — the current
    token, then the row's k drafts (pad where it has none) — written at
    ``positions[i] .. positions[i] + k`` and scored in one pass (the
    reference's ``_verify_window``, ``paddle_tpu/serving/engine.py:1336``,
    whose acceptance the engine runs on the outputs, outside the graph).
    Host mirrors: ``tokens_host`` (B, window), ``positions_host``,
    ``tables_host`` as in the decode step, and ``ok_host`` (B, k), the
    engine's real-draft mask, uploaded with them for the acceptance
    (``ok``; the step itself does not read it).  :meth:`run` returns
    (logits (B, window, vocab), their argmax (B, window)).  Built once,
    under the decode step's site and labels."""

    def __init__(self, model, cache, num_slots: int, window: int,
                 max_blocks: Optional[int], device: torch.device,
                 engine_id, graph: Optional[str] = None):
        labels = {"engine": engine_id}
        if graph is not None:
            labels["graph"] = graph
        _Step.__init__(self, device, labels)
        self._model = model
        self._cache = cache
        b, w = num_slots, window
        nt, bp, nk = _align4(b * w), _align4(b), _align4(b * (w - 1))
        n = nt + bp + nk + (b * max_blocks if max_blocks else 0)
        self._stage, host, self._inputs = _staging(n, device)
        self.tokens_host = host[:b * w].reshape(b, w)
        self.positions_host = host[nt:nt + b]
        self.ok_host = host[nt + bp:nt + bp + b * (w - 1)].reshape(b, w - 1)
        self.tokens = self._inputs[:b * w].view(b, w)
        self.positions = self._inputs[nt:nt + b]
        self.ok = self._inputs[nt + bp:nt + bp + b * (w - 1)].view(b, w - 1)
        self.tables_host = self.tables = None
        if max_blocks:
            o = nt + bp + nk
            self.tables_host = host[o:].reshape(b, max_blocks)
            self.tables = self._inputs[o:].view(b, max_blocks)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = self._model.decode_step(self.tokens, self._cache,
                                            self.positions,
                                            block_tables=self.tables)
        return logits, logits.argmax(dim=-1)


class MixedStep(_Step):
    """The chunked engine's mixed step: ``decode``'s rows (its static
    buffers, shared), then one chunk of ``chunk`` prompt tokens of one
    slot at positions ``cpos .. cpos + chunk - 1``.  Chunk inputs, each
    with its host mirror (``*_host``, views of this step's staging): the
    ids (``chunk``,), ``pos`` and ``len`` (1,) (tokens past ``len`` are
    pad), and the slot — paged: its block-table row (``table``,
    (max_blocks,), pad-tail positions past the chain land in the null
    block); contiguous: its cache row (``row``, (1,)), which the chunk
    writes in place (positions at or past ``max_length`` dropped) and
    reads on K2-paged through the cache's identity view.  :meth:`run`
    returns (decode logits (B, vocab), their argmax (B,), the chunk's
    logits at ``len - 1`` (1, vocab), their argmax (1,)): the one hidden
    row is gathered before the LM head, so no (chunk, vocab) logits are
    built."""

    def __init__(self, decode: DecodeStep, chunk: int,
                 max_blocks: Optional[int], engine_id):
        super().__init__(decode.device, {"engine": engine_id})
        self._decode = decode
        cp = _align4(chunk)
        n = cp + 4 + (_align4(max_blocks) if max_blocks else 4)
        self._stage, host, self._inputs = _staging(n, decode.device)
        self.ids_host = host[:chunk]
        self.pos_host = host[cp:cp + 1]
        self.len_host = host[cp + 1:cp + 2]
        self.ids = self._inputs[:chunk].view(1, chunk)
        self.pos = self._inputs[cp:cp + 1]
        self.len = self._inputs[cp + 1:cp + 2]
        self.table_host = self.table = self.row_host = self.row = None
        if max_blocks:
            self.table_host = host[cp + 4:cp + 4 + max_blocks]
            self.table = self._inputs[cp + 4:cp + 4 + max_blocks].view(
                1, max_blocks)
        else:
            self.row_host = host[cp + 2:cp + 3]
            self.row = self._inputs[cp + 2:cp + 3]

    def _upload(self, non_blocking: bool) -> None:
        self._decode._upload(non_blocking)
        self._inputs.copy_(self._stage, non_blocking=non_blocking)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, ...]:
        d = self._decode
        logits, greedy = d._body()
        model = d._model
        hidden, _ = model.model.decode(self.ids, d._cache, self.pos,
                                       block_tables=self.table,
                                       rows=self.row)
        last = hidden[0].index_select(0, (self.len - 1).long())
        clogits = model.logits(last)
        return logits, greedy, clogits, clogits.argmax(dim=-1)


class PrefillStep(_Step):
    """One prefill wave of ``rows`` prompts padded to ``bucket`` tokens
    over static buffers, built once a key; see the module docstring.
    Inputs, each with its host mirror (``*_host``, views of this step's
    staging, written by :meth:`stage`): the ids (rows, bucket), each row's
    last real position (rows,), and the slots — paged: the adopted prefix
    lengths (rows,) and the block tables (rows, max_blocks); contiguous:
    the cache rows (rows,).  :meth:`run` returns (logits (rows, vocab) at
    each row's last real position, their argmax (rows,)).

    The body is the eager wave's math, unchanged.  Contiguous: the ``pos
    = 0`` pass (flash attention, K2) over a bucket-long scratch cache,
    then the rows' first ``bucket`` positions of their slots replaced by
    the scratch — int8: the whole granules the bucket touches, the slots'
    scale rows zeroed first, so past the copied granules a slot keeps
    stale payload under zero scales, which the first write of a granule
    clears.  The scratch is the step's own: allocated by the capture, in
    the engine's prefill pool, and zeroed by each replay (eagerly, by each
    run).  Paged: each row's suffix as a decode at depth over the pool
    (per-row ``pos`` = adopted prefix; K2-paged reads the adopted blocks),
    writes straight into the rows' own blocks, bucket padding into the
    null block.

    The build's warm-up and capture run the paged step on all-null tables
    at prefix 0, so they write only the null block; the contiguous step
    on the staged wave, so they write only its own slots, which the
    replay writes again.  ``PREFILL_WARMUP`` eager runs precede the
    capture (none: see there)."""

    SITE = "serving.prefill"
    WARMUP = PREFILL_WARMUP

    def __init__(self, model, cache, bucket: int, rows: int,
                 max_blocks: Optional[int], device: torch.device,
                 engine_id, eager: bool = False, pool=None):
        super().__init__(device, {"engine": engine_id, "bucket": bucket,
                                  "rows": rows}, eager=eager, pool=pool)
        self._model = model
        self._cache = cache
        self.bucket, self.rows = bucket, rows
        ni, rp = _align4(rows * bucket), _align4(rows)
        n = ni + 2 * rp + (rows * max_blocks if max_blocks else 0)
        self._stage, host, self._inputs = _staging(n, device)
        self.ids_host = host[:rows * bucket].reshape(rows, bucket)
        self.last_host = host[ni:ni + rows]
        self.ids = self._inputs[:rows * bucket].view(rows, bucket)
        self.last = self._inputs[ni:ni + rows]
        o = ni + rp
        self.slots_host = self.slots = None
        self.prefix_host = self.prefix = None
        self.tables_host = self.tables = None
        if max_blocks:
            self.prefix_host = host[o:o + rows]
            self.prefix = self._inputs[o:o + rows]
            self.tables_host = host[o + rp:].reshape(rows, max_blocks)
            self.tables = self._inputs[o + rp:].view(rows, max_blocks)
        else:
            self.slots_host = host[o:o + rows]
            self.slots = self._inputs[o:o + rows]

    def stage(self, ids, last, slots=None, prefix=None, tables=None) -> None:
        """Write one wave's inputs into the host mirrors."""
        self.ids_host[:] = ids
        self.last_host[:] = last
        if self.tables_host is None:
            self.slots_host[:] = slots
        else:
            self.prefix_host[:] = prefix
            self.tables_host[:] = tables

    def _build(self) -> None:
        if self.tables_host is None:
            return super()._build()
        real = self._stage.clone()
        self._stage.zero_()            # all-null tables, prefix 0
        try:
            super()._build()
        finally:
            self._stage.copy_(real)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        model, cache, dev = self._model, self._cache, self.device
        n, bucket = self.rows, self.bucket
        if self.tables is not None:
            hidden, _ = model.model.decode(self.ids, cache, self.prefix,
                                           block_tables=self.tables)
        else:
            quantized = isinstance(cache, dict)
            if quantized:
                kv, sc = cache["kv"], cache["scale"]
                gr = kv.shape[3] // sc.shape[3]
                ng = -(-bucket // gr)
                sub = init_kv_cache(model.config, n, ng * gr,
                                    quantized=True, device=dev)
            else:
                sub = init_kv_cache(model.config, n, bucket, device=dev)
            hidden, sub = model.model.decode(self.ids, sub, 0)
            slots = self.slots.long()
            if quantized:
                # a fill by value: an index write of 0.0 would copy a CPU
                # scalar, which a capture refuses
                sc.index_fill_(2, slots, 0.0)
                sc[:, :, slots, :ng] = sub["scale"]
                kv[:, :, slots, :ng * gr] = sub["kv"]
            else:
                cache[:, :, slots, :bucket] = sub
        last = hidden[torch.arange(n, device=dev), self.last.long()]
        logits = model.logits(last)
        return logits, logits.argmax(dim=-1)


class DraftStep(_Step):
    """The draft model's draft step (the reference's ``_draft_impl``,
    ``paddle_tpu/serving/drafter.py:187``), over the drafter's contiguous
    cache: a window of up to k + 1 caught-up tokens a row at its
    ``start`` (``window`` (S, k + 1), ``start`` and ``nvalid`` (S,), host
    mirrors ``*_host``), the next-token logits at each row's last valid
    column, then k - 1 one-token steps, each on the previous draft.  Each
    column's proposal distribution q is the softmax of the UNTEMPERED draft
    logits; its draft is ``argmax(logits + noise[:, j])``: the argmax
    where ``noise`` is 0 (greedy rows), a draw from q where it holds
    Gumbel noise (sampled rows; the drafter fills it outside the graph).
    A row at ``start = max_length`` writes nothing (the port's dropped
    writes).  :meth:`run` returns (drafts (S, k) int32, q (S, k, V)
    float32).  Counted under ``serving.draft_step`` (budget 1)."""

    SITE = "serving.draft_step"

    def __init__(self, model, cache, num_slots: int, k: int,
                 device: torch.device, engine_id, eager=None):
        super().__init__(device, {"engine": engine_id}, eager=eager)
        self._model, self._cache, self.k = model, cache, k
        s, w = num_slots, k + 1
        nw, sp = _align4(s * w), _align4(s)
        self._stage, host, self._inputs = _staging(nw + 2 * sp, device)
        self.window_host = host[:s * w].reshape(s, w)
        self.start_host = host[nw:nw + s]
        self.nvalid_host = host[nw + sp:nw + sp + s]
        self.window = self._inputs[:s * w].view(s, w)
        self.start = self._inputs[nw:nw + s]
        self.nvalid = self._inputs[nw + sp:nw + sp + s]
        self.noise = torch.zeros((s, k, model.config.vocab_size),
                                 dtype=torch.float32, device=device)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        model, cache = self._model, self._cache
        s = self.window.shape[0]
        hidden, _ = model.model.decode(self.window, cache, self.start)
        idx = (self.nvalid - 1).clamp_min(0).long()
        last = hidden[torch.arange(s, device=self.device), idx]
        lg = model.logits(last).float()
        drafts, probs = [], []
        for j in range(self.k):
            probs.append(torch.softmax(lg, dim=-1))
            tok = (lg + self.noise[:, j]).argmax(dim=-1)
            drafts.append(tok)
            if j < self.k - 1:
                hidden, _ = model.model.decode(
                    tok[:, None], cache, self.start + self.nvalid + j)
                lg = model.logits(hidden[:, 0]).float()
        return (torch.stack(drafts, dim=1).to(torch.int32),
                torch.stack(probs, dim=1))


class IngestStep(_Step):
    """The draft model's ingest step (the reference's ``_ingest_impl``,
    ``paddle_tpu/serving/drafter.py:217``): ``width`` history tokens a row
    written into the drafter's cache at ``start`` (rows at ``max_length``
    write nothing), no logits — it drains a long backlog (a new prompt)
    ahead of the draft step.  Counted under ``serving.draft_prefill``
    (budget 1)."""

    SITE = "serving.draft_prefill"

    def __init__(self, model, cache, num_slots: int, width: int,
                 device: torch.device, engine_id, eager=None):
        super().__init__(device, {"engine": engine_id}, eager=eager)
        self._model, self._cache = model, cache
        s = num_slots
        nw = _align4(s * width)
        self._stage, host, self._inputs = _staging(nw + s, device)
        self.window_host = host[:s * width].reshape(s, width)
        self.start_host = host[nw:nw + s]
        self.window = self._inputs[:s * width].view(s, width)
        self.start = self._inputs[nw:nw + s]

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor]:
        self._model.model.decode(self.window, self._cache, self.start)
        return ()
