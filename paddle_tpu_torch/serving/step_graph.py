"""The serving engine's once-built steps (the reference's ``serving.step``
site, ``paddle_tpu/serving/engine.py:672-708``): the decode step
(:class:`DecodeStep`) and, in the chunked engine, the mixed step
(:class:`MixedStep`).

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

What the capture fixes, and so what a replay cannot see change: the
model's weights and the engine's cache (both written or read in place at
their addresses), the split length of flash-decode
(``FLAGS_decode_attention_block_kv``, read at capture), K4's K split and
tensor maps (fixed by shape and address), and which kernels run (the
route of each op at capture).  Launch counters are credited per replay
(``ops.ReplayCounts``), so ``.launches`` counts replays x launches per
graph, as an eager run of the same ticks would.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Optional, Tuple

import torch

from .. import ops
from ..observability import track_retraces
from ..ops.cuda.decode_attention import private_counters

# eager runs before the capture: the first builds and loads every kernel;
# the second runs the step as the capture will see it
WARMUP_TICKS = 2

_disabled = False


@contextlib.contextmanager
def disable_graphs():
    """The port's ``jax.disable_jit()``: an engine that builds its decode
    step while this is open runs the step eagerly on the card — the same
    static-buffer step, one build all the same, no graph.  Read at the
    build, so the engine keeps its mode after the context closes.  For
    eager twins of a graphed engine (``chip_smoke.py``)."""
    global _disabled
    prev = _disabled
    _disabled = True
    try:
        yield
    finally:
        _disabled = prev


class _Step:
    """A step over static buffers, built once (counted, budget 1) and run
    once a tick; see the module docstring.  Subclasses define
    :meth:`_body` (the step on the static buffers) and :meth:`_upload`
    (the host staging to the device buffers)."""

    def __init__(self, device: torch.device, labels: dict):
        self.device = device
        self._graph = None
        self._out: Optional[Tuple[torch.Tensor, ...]] = None
        self._counts: Optional[ops.ReplayCounts] = None
        self._counters: dict = {}
        self._stream = None
        self.replays = 0
        self._tracked = track_retraces(self._build, "serving.step", budget=1,
                                       labels=labels)

    @property
    def traces(self) -> int:
        """Builds of this step (the engine's ``step_traces``)."""
        return self._tracked.traces

    @property
    def graphed(self) -> bool:
        return self._graph is not None

    def build(self) -> None:
        """Build the step: counted, budget 1 (a second build is a watchdog
        violation, ``FLAGS_retrace_watchdog``).  Call while no slot holds
        a request: the warm-up runs real ticks of whatever the host
        mirrors hold, which must be idle rows (and, mixed, a chunk whose
        writes all drop)."""
        self._tracked()

    def _upload(self, non_blocking: bool) -> None:
        raise NotImplementedError

    def _body(self) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def _build(self) -> None:
        self._graph = self._out = self._counts = None
        if self.device.type != "cuda" or _disabled:
            return
        self._upload(False)
        stream = torch.cuda.Stream(device=self.device)
        counters: dict = {}
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream), private_counters(counters):
            for _ in range(WARMUP_TICKS):
                self._body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        held = {k: t.data_ptr() for k, t in counters.items()}
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: freeing an unreachable
        # engine's graph there (a reset) invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with ops.ReplayCounts.record() as counts, \
                    private_counters(counters):
                with torch.cuda.graph(graph, stream=stream):
                    out = self._body()
        finally:
            if collecting:
                gc.enable()
        if {k: t.data_ptr() for k, t in counters.items()} != held:
            raise RuntimeError(
                "serving.step: the capture allocated K1 merge counters the "
                "warm-up did not; the graph would write memory it does not "
                "own")
        self._graph, self._out, self._counts = graph, out, counts
        # the graph holds raw pointers into these: keep them for its life
        self._counters, self._stream = counters, stream

    def run(self) -> Tuple[torch.Tensor, ...]:
        """One tick: upload the host mirrors, then replay the graph (or
        run the step eagerly).  Returns the step's outputs on the device —
        the graph's static outputs, overwritten by the next tick."""
        self._upload(True)
        if self._graph is None:
            return self._body()
        self._graph.replay()
        self._counts.add()
        self.replays += 1
        return self._out


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

    def _upload(self, non_blocking: bool) -> None:
        self._inputs.copy_(self._stage, non_blocking=non_blocking)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = self._model.decode_step(self.tokens, self._cache,
                                            self.positions,
                                            block_tables=self.tables)
        logits = logits[:, -1]
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
