"""Diffusion sampling for the DiT family — DDIM with classifier-free
guidance (mirrors ``paddle_tpu/models/diffusion.py``).

Conventions are the reference's: linear betas over
``num_train_timesteps``, the cumulative alpha-bar table in float32, a
strided descending subset of timesteps whose last "next" alpha-bar is 1
(the clean sample); the model predicts epsilon in its first
``in_channels`` channels (DiT's sigma channels are ignored); guidance runs
the conditional and unconditional halves as one doubled batch against the
null class ``num_classes``; ``eta = 0`` is deterministic DDIM, ``eta = 1``
ancestral-DDPM noise levels.

Built once: the reference jits the whole reverse process once per
(batch, steps, cfg_scale, eta, T, from_noise) key and caches it on the
model (``_ddim_jit_cache``, :71-76).  The port builds one
:class:`DDIMSampler` per key, cached on the model under the same name and
counted by the watchdog (site ``diffusion.ddim``, budget 1 a key).  Each
sampler records where the weights lived when it was built, and a call
drops the samplers of other weights first
(``serving.step_graph.cached_program``): the graph reads the weights at
their addresses, so a model converted to another dtype and back builds
anew instead of replaying into freed memory.  On the card its build
captures ONE denoising step as a CUDA graph — the step index lives in a
device buffer the step reads (timestep, alpha-bars, noise) and
increments, the schedule tables live on the device — and a sample replays
that graph ``steps`` times.  Before the replays the
sampler writes the labels, the initial latent (``x_init``, or noise) and,
for ``eta > 0``, every step's noise into static buffers outside the
graph.  On the CPU, and inside ``serving.step_graph.disable_graphs()``
(read at the build), the same step runs eagerly on the same buffers.

Noise comes from a ``torch.Generator`` on the model's device seeded with
``seed``: the initial latent first, then the ``(steps, B, C, H, W)``
noise of ``eta > 0``.  JAX's PRNG streams cannot be reproduced, so
samples from noise match the reference in distribution only; from the
same ``x_init`` at ``eta = 0`` they match it value for value.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import ops
from ..observability import track_retraces

__all__ = ["DDIMSampler", "ddim_sample", "diffusion_schedule",
           "ddim_timesteps"]


# XLA's CPU loop fusion of linspace: from this many points on, LLVM keeps
# the vectorized loop (8 lanes x 4 unrolled = 32 points an iteration)
# instead of unrolling it and folding its constants
_LINSPACE_LOOP_MIN = 353
_LINSPACE_LOOP_STEP = 32


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` at float32 as XLA compiles it on
    the CPU, bit for bit.  JAX computes ``start * (1 - i / div) + stop *
    (i / div)`` with ``div = num - 1``; XLA turns the division into a
    product by ``r = 1 / div`` rounded to float32, and the host's code
    generator contracts products and sums into FMAs.  Point ``i < div`` is
    ``fma(i, stop * r, start * t_i)`` (one rounding: ``i * (stop * r)`` and
    the sum are exact in float64), the last point exactly ``stop``.  The
    factor ``t_i`` takes one of two forms:

      * folded: ``1 - round(i * r)``, which LLVM computes when it folds
        the constant ``1 - i * r`` — every point below
        ``_LINSPACE_LOOP_MIN`` points, where the loop is fully unrolled,
        and the remainder past the last whole 32-point iteration above it;
      * fused: ``round(1 - i * r)`` (``vfnmadd``), in the vectorized
        loop's iterations from ``_LINSPACE_LOOP_MIN`` points on.

    The two forms differ in the last bit at some points, and a tie of
    :func:`ddim_timesteps`' rounding is decided by those bits.  The loop
    shape (8 float32 lanes, 4 unrolled) and the threshold were read from
    XLA's LLVM IR and object code of the ``linspace`` fusion on an x86-64
    host with FMA and AVX-512 (jaxlib 0.9.0); another vector width moves
    them."""
    f32 = torch.float32
    if num == 1:
        return torch.tensor([start], dtype=f32)
    div = num - 1
    a = torch.tensor(start, dtype=f32)
    b = torch.tensor(stop, dtype=f32)
    r = torch.tensor(1.0, dtype=f32) / div
    i = torch.arange(div, dtype=f32)
    folded = 1 - i * r
    fused = (1.0 - i.double() * r.double()).to(f32)
    loop_end = (div // _LINSPACE_LOOP_STEP * _LINSPACE_LOOP_STEP
                if num >= _LINSPACE_LOOP_MIN else 0)
    t = torch.where(torch.arange(div) < loop_end, fused, folded)
    head = a * t
    out = (i.double() * (b * r).double() + head.double()).to(f32)
    return torch.cat([out, b[None]])


def diffusion_schedule(num_train_timesteps: int = 1000,
                       beta_start: float = 1e-4,
                       beta_end: float = 0.02) -> torch.Tensor:
    """Linear-beta DDPM schedule -> cumulative alpha-bar table (T,)
    float32 (on the CPU)."""
    betas = _linspace_f32(beta_start, beta_end, num_train_timesteps)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(steps: int, num_train_timesteps: int = 1000
                   ) -> torch.Tensor:
    """The strided descending timesteps (steps,) int64: the reference's
    ``jnp.linspace(T - 1, 0, steps).round()`` (half to even)."""
    return torch.round(_linspace_f32(num_train_timesteps - 1, 0,
                                     steps)).long()


class DDIMSampler:
    """One (batch, steps, cfg_scale, eta, T, from_noise) key's reverse
    process over static buffers, built once; see the module docstring.
    :meth:`run` draws one sample batch."""

    SITE = "diffusion.ddim"

    def __init__(self, model, b: int, steps: int, cfg_scale: float,
                 eta: float, num_train_timesteps: int, from_noise: bool):
        c = model.config
        dev = model.patch_proj.device
        self.model, self.device = model, dev
        self.b, self.steps = b, steps
        self.cfg_scale, self.eta = cfg_scale, eta
        self.from_noise = from_noise
        self.use_cfg = cfg_scale != 1.0
        acp = diffusion_schedule(num_train_timesteps)
        ts = ddim_timesteps(steps, num_train_timesteps)
        self.ts = ts.to(dev)
        self.acp_t = acp[ts].to(dev)
        self.acp_next = torch.cat([acp[ts[1:]], torch.ones(1)]).to(dev)
        shape = (b, c.in_channels, c.input_size, c.input_size)
        self.x = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.y = torch.zeros(b, dtype=torch.long, device=dev)
        self.null_y = torch.full((b,), c.num_classes, dtype=torch.long,
                                 device=dev)
        self.i = torch.zeros(1, dtype=torch.long, device=dev)
        self.noise = (torch.zeros((steps, *shape), dtype=torch.float32,
                                  device=dev) if eta != 0 else None)
        from ..serving import step_graph
        # eager on the CPU or inside disable_graphs() (read here, and the
        # build follows at once): an eager twin is a build of its own
        self.eager = dev.type != "cuda" or step_graph._disabled
        self._graph = None
        self._counts: Optional[ops.ReplayCounts] = None
        self._counters: dict = {}
        self._stream = None
        self.replays = 0
        self.weights = step_graph.weights_key(model)
        self._tracked = track_retraces(
            self._build, self.SITE, budget=1,
            labels={"model": id(model), "b": b, "steps": steps,
                    "cfg_scale": cfg_scale, "eta": eta,
                    "T": num_train_timesteps, "from_noise": from_noise,
                    "eager": self.eager, "weights": self.weights})

    @property
    def traces(self) -> int:
        """Builds of this key (1 once built)."""
        return self._tracked.traces

    @property
    def graphed(self) -> bool:
        return self._graph is not None

    def build(self) -> None:
        self._tracked()

    def _eps(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        m, c_in = self.model, self.model.config.in_channels
        if self.use_cfg:
            out = m(torch.cat([x, x]), torch.cat([t, t]),
                    torch.cat([self.y, self.null_y]))
            eps = out[:, :c_in].float()
            e_cond, e_null = eps[:self.b], eps[self.b:]
            return e_null + self.cfg_scale * (e_cond - e_null)
        return m(x, t, self.y)[:, :c_in].float()

    def _step(self) -> None:
        """One denoising step at index ``self.i``, in place on ``self.x``;
        then ``self.i += 1``.  Reads nothing back to the host."""
        i = self.i
        x = self.x
        a_t, a_n = self.acp_t[i], self.acp_next[i]
        eps = self._eps(x, self.ts[i].expand(self.b))
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        sigma = (self.eta * torch.sqrt((1.0 - a_n) / (1.0 - a_t))
                 * torch.sqrt(torch.clamp(1.0 - a_t / a_n, min=0.0)))
        dir_x = torch.sqrt(torch.clamp(1.0 - a_n - sigma ** 2, min=0.0)) \
            * eps
        new = torch.sqrt(a_n) * x0 + dir_x
        if self.noise is not None:
            new = new + self.noise[i][0] * sigma
        x.copy_(new)
        i.add_(1)

    def _build(self) -> None:
        if self.eager:
            return
        from ..serving.step_graph import capture
        # a warm-up step builds and loads every kernel before the capture;
        # run() rewrites x and i
        ((self._graph, _, self._counts),), self._counters, self._stream = \
            capture([self._step], self.device, 1, what=self.SITE)

    def run(self, y: torch.Tensor, seed: int = 0,
            x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample latents (B, C, H, W) float32 for labels ``y`` (B,):
        fill the static buffers, then ``steps`` replays (or eager steps).
        Returns a fresh tensor."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            self.y.copy_(y)
            if self.from_noise:
                self.x.copy_(torch.randn(self.x.shape, generator=gen,
                                         device=self.device))
            else:
                self.x.copy_(x_init)
            if self.noise is not None:
                self.noise.copy_(torch.randn(self.noise.shape,
                                             generator=gen,
                                             device=self.device))
            self.i.zero_()
            for _ in range(self.steps):
                if self._graph is None:
                    self._step()
                else:
                    self._graph.replay()
                    self._counts.add()
                    self.replays += 1
            return self.x.clone()


def ddim_sample(model, y, *, steps: int = 50, cfg_scale: float = 1.0,
                eta: float = 0.0, seed: int = 0,
                num_train_timesteps: int = 1000,
                x_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample latents from a DiT given class labels ``y`` (B,) ints.

    ``cfg_scale != 1`` enables classifier-free guidance against the
    model's null class (the ``num_classes`` row of ``y_embed``).  Runs on
    the model's device; returns (B, in_channels, H, W) float32 latents.
    The first call of a key builds its :class:`DDIMSampler`
    (``model._ddim_jit_cache[key]``); later calls over the same weight
    storage reuse it."""
    dev = model.patch_proj.device
    y = torch.as_tensor(y).to(device=dev, dtype=torch.long)
    b = y.shape[0]
    from_noise = x_init is None
    key_ = (b, steps, cfg_scale, eta, num_train_timesteps, from_noise)
    from ..serving.step_graph import cached_program
    sampler = cached_program(model, "_ddim_jit_cache", key_,
                             lambda: DDIMSampler(
                                 model, b, steps, cfg_scale, eta,
                                 num_train_timesteps, from_noise))
    if x_init is not None:
        x_init = torch.as_tensor(x_init).to(device=dev, dtype=torch.float32)
    return sampler.run(y, seed, x_init)
