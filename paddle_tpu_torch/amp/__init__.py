"""Automatic mixed precision (mirrors ``paddle_tpu/amp/__init__.py``).

The reference's AMP stack: :func:`auto_cast` (O1: white-listed ops compute
in the cast dtype, black-listed ones stay float32), :func:`decorate` (O2:
the model's floating tensors cast once, the optimizer keeping float32
master weights) and :class:`GradScaler`, the dynamic loss scaler a
float16 step needs (float16 ends at 65504 and its smallest normal is
6.1e-5; bf16 has float32's range and trains with ``enable=False``).

The lists and the scaler's update rule are the reference's own, kept here
as a copy.  The scaler's functional core works on 0-d tensors (``scale``
float32, ``good_steps`` / ``bad_steps`` int32) exactly as the reference's
does on its arrays; the imperative API maps ``step`` onto the port's
:meth:`~paddle_tpu_torch.optimizer.Optimizer.step`.  The model's seam for
O1 is ``nn.quant.linear``, through which every Llama projection and the
LM head pass (the reference's AMP-aware ``matmul``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Set

import torch

__all__ = ["auto_cast", "autocast", "GradScaler", "decorate",
           "get_policy", "compute_dtype", "cast_inputs", "WHITE_LIST",
           "BLACK_LIST"]

# ops that compute in the cast dtype (the reference's amp_lists)
WHITE_LIST: Set[str] = {
    "matmul", "linear", "conv2d", "conv1d", "einsum", "attention",
    "flash_attention", "bmm", "mm",
}
# numerically sensitive ops kept in float32
BLACK_LIST: Set[str] = {
    "softmax", "log_softmax", "cross_entropy", "layer_norm", "rms_norm",
    "group_norm", "batch_norm", "log", "exp", "sum", "mean", "norm",
    "cumsum", "softplus",
}

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}

_state = threading.local()


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"amp: unknown dtype {dtype!r}") from None


class _Policy:
    __slots__ = ("enable", "dtype", "level", "white", "black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


def get_policy() -> Optional[_Policy]:
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """Context under which white-listed ops compute in ``dtype``."""
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    pol = _Policy(enable, _to_dtype(dtype), level, white, black)
    prev = get_policy()
    _state.policy = pol
    try:
        yield
    finally:
        _state.policy = prev


autocast = auto_cast  # alias


def compute_dtype(op_name: str, *xs) -> Optional[torch.dtype]:
    """The dtype op ``op_name`` computes in under the active policy; None
    when nothing is cast (no policy, disabled, black-listed or not
    white-listed, or a non-floating tensor input)."""
    pol = get_policy()
    if pol is None or not pol.enable:
        return None
    if op_name in pol.black or op_name not in pol.white:
        return None
    for x in xs:
        if isinstance(x, torch.Tensor) and not x.is_floating_point():
            return None
    return pol.dtype


def _cast(x, dt):
    if (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dtype != dt):
        return x.to(dt)
    return x


def cast_inputs(op_name: str, *xs):
    """``xs`` cast to the policy's dtype for ``op_name`` (floating tensors
    only; None and the rest as they are), or ``xs`` unchanged."""
    dt = compute_dtype(op_name, *xs)
    if dt is None:
        return xs
    return tuple(_cast(x, dt) for x in xs)


class GradScaler:
    """Dynamic loss scaler (parity: ``paddle.amp.GradScaler``).

    Functional use (what ``distributed.build_train_step`` does)::

        state = scaler.init_state()
        grads = autograd.grad(scaler.scale_with(state, loss), params)
        grads, found_inf = scaler.unscale_with(state, grads)
        state = scaler.update_state(state, found_inf)
        # skip the optimizer update where found_inf

    The imperative API (``scale`` / ``unscale_`` / ``step`` / ``update``)
    keeps its state on the scaler."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._init_scale = float(init_loss_scaling)
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self.dynamic = use_dynamic_loss_scaling
        self._state = self.init_state()
        self._found_inf = torch.zeros((), dtype=torch.bool)
        self._unscaled = False

    # -- functional core ----------------------------------------------------

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {
            "scale": torch.tensor(self._init_scale if self._enable else 1.0,
                                  dtype=torch.float32),
            "good_steps": torch.zeros((), dtype=torch.int32),
            "bad_steps": torch.zeros((), dtype=torch.int32),
        }

    def scale_with(self, state, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return loss
        # a 0-d host tensor: read on the host, no copy to the device
        return loss * state["scale"].to(loss.dtype)

    def unscale_with(self, state, grads: Mapping[str, torch.Tensor]):
        """(unscaled grads, found_inf): each gradient times 1 / scale in
        float32, back in its own dtype; found_inf a 0-d bool, whether any
        element of any gradient is not finite (checked in float32), on
        the gradients' device: nothing is read back here."""
        grads = dict(grads)
        found = torch.zeros((), dtype=torch.bool)
        if not self._enable:
            return grads, found
        # 1 / scale in float32 (the state lives on the host)
        inv = float(torch.reciprocal(state["scale"].float()))
        out = {}
        for k, g in grads.items():
            g32 = g.float()
            bad = ~torch.isfinite(g32).all()
            found = found.to(bad.device) | bad
            out[k] = (g32 * inv).to(g.dtype)
        return out, found

    def update_state(self, state, found_inf) -> Dict[str, torch.Tensor]:
        if not (self._enable and self.dynamic):
            return state
        found = torch.as_tensor(found_inf, dtype=torch.bool).cpu()
        scale, good = state["scale"], state["good_steps"]
        bad = state["bad_steps"]
        bad = torch.where(found, bad + 1, torch.zeros_like(bad))
        good = torch.where(found, torch.zeros_like(good), good + 1)
        shrink = bad >= self.decr_every_n_nan_or_inf
        grow = good >= self.incr_every_n_steps
        scale = torch.where(shrink, scale * self.decr_ratio, scale)
        scale = torch.where(grow, scale * self.incr_ratio, scale)
        bad = torch.where(shrink, torch.zeros_like(bad), bad)
        good = torch.where(grow, torch.zeros_like(good), good)
        return {"scale": scale, "good_steps": good, "bad_steps": bad}

    # -- imperative mirror (reference API) -----------------------------------

    def is_enable(self) -> bool:
        return self._enable

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        return self.scale_with(self._state, loss)

    def unscale_(self, grads):
        grads, found = self.unscale_with(self._state, grads)
        self._found_inf = found
        self._unscaled = True
        return grads

    def step(self, optimizer, grads) -> None:
        """Unscale (if the caller did not) and apply ``optimizer``'s step
        unless a gradient was not finite (the reference's
        ``GradScaler.step``, which unscales internally)."""
        if not self._unscaled:
            grads = self.unscale_(grads)
        if bool(self._found_inf):
            return
        optimizer.step(grads)

    def minimize(self, optimizer, grads) -> None:  # reference-parity alias
        self.step(optimizer, grads)
        self.update()

    def update(self) -> None:
        self._state = self.update_state(self._state, self._found_inf)
        self._found_inf = torch.zeros((), dtype=torch.bool)
        self._unscaled = False

    @property
    def loss_scaling(self) -> torch.Tensor:
        return self._state["scale"]


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None):
    """O2 decoration (parity: ``paddle.amp.decorate``): at O2 every
    floating parameter and buffer of each model goes to ``dtype`` in
    place (the reference's ``Layer.astype`` casts the buffers too, the
    RoPE tables among them); each optimizer keeps float32 master weights
    (``_multi_precision``) unless ``master_weight`` is False.  Returns
    the model(s), or (model(s), optimizer(s)) when optimizers are
    given."""
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        dt = _to_dtype(dtype)
        for m in ms:
            m.to(dtype=dt)
    if optimizers is not None:
        single_o = not isinstance(optimizers, (list, tuple))
        os_ = [optimizers] if single_o else list(optimizers)
        for o in os_:
            if master_weight is not False:
                o._multi_precision = True
        if single_o:
            optimizers = os_[0]
    if single:
        ms = ms[0]
    return (ms, optimizers) if optimizers is not None else ms
