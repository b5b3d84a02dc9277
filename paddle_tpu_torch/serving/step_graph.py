"""The serving engine's once-built decode step (the reference's
``serving.step`` site, ``paddle_tpu/serving/engine.py:676-700``).

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


class DecodeStep:
    """One engine's decode step over static buffers; see the module
    docstring.  ``tokens_host`` / ``positions_host`` / ``tables_host``
    are the engine's host mirrors (numpy views of the staging buffer);
    :meth:`build` is the counted build (budget 1), :meth:`run` one tick."""

    def __init__(self, model, cache, num_slots: int,
                 max_blocks: Optional[int], device: torch.device,
                 engine_id: int):
        self._model = model
        self._cache = cache
        self.device = device
        b = num_slots
        bp = -(-b // 4) * 4            # 16-byte aligned sections
        n = 2 * bp + (b * max_blocks if max_blocks else 0)
        self._stage = torch.zeros(n, dtype=torch.int32,
                                  pin_memory=device.type == "cuda")
        host = self._stage.numpy()
        self.tokens_host = host[:b]
        self.positions_host = host[bp:bp + b]
        self._inputs = torch.zeros(n, dtype=torch.int32, device=device)
        self.tokens = self._inputs[:b].view(b, 1)
        self.positions = self._inputs[bp:bp + b]
        self.tables_host = self.tables = None
        if max_blocks:
            self.tables_host = host[2 * bp:].reshape(b, max_blocks)
            self.tables = self._inputs[2 * bp:].view(b, max_blocks)
        self._graph = None
        self._out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._counts: Optional[ops.ReplayCounts] = None
        self._counters: dict = {}
        self._stream = None
        self.replays = 0
        self._tracked = track_retraces(self._build, "serving.step", budget=1,
                                       labels={"engine": engine_id})

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
        mirrors hold, which must be idle rows (pad tokens at position 0,
        all-null tables)."""
        self._tracked()

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = self._model.decode_step(self.tokens, self._cache,
                                            self.positions,
                                            block_tables=self.tables)
        logits = logits[:, -1]
        return logits, logits.argmax(dim=-1)

    def _build(self) -> None:
        self._graph = self._out = self._counts = None
        if self.device.type != "cuda" or _disabled:
            return
        self._inputs.copy_(self._stage)
        stream = torch.cuda.Stream(device=self.device)
        counters: dict = {}
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream), private_counters(counters):
            for _ in range(WARMUP_TICKS):
                self._body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        held = {k: t.data_ptr() for k, t in counters.items()}
        graph = torch.cuda.CUDAGraph()
        with ops.ReplayCounts.record() as counts, private_counters(counters):
            with torch.cuda.graph(graph, stream=stream):
                out = self._body()
        if {k: t.data_ptr() for k, t in counters.items()} != held:
            raise RuntimeError(
                "serving.step: the capture allocated K1 merge counters the "
                "warm-up did not; the graph would write memory it does not "
                "own")
        self._graph, self._out, self._counts = graph, out, counts
        # the graph holds raw pointers into these: keep them for its life
        self._counters, self._stream = counters, stream

    def run(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One tick: upload the host mirrors, then replay the graph (or
        run the step eagerly).  Returns (logits (B, vocab), greedy tokens
        (B,)) on the device — the graph's static outputs, overwritten by
        the next tick."""
        self._inputs.copy_(self._stage, non_blocking=True)
        if self._graph is None:
            return self._body()
        self._graph.replay()
        self._counts.add()
        self.replays += 1
        return self._out
