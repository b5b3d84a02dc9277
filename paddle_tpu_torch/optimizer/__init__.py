"""Optimizers (mirrors ``paddle_tpu/optimizer/__init__.py``).

The same functional core as the reference: ``state = opt.init(params)``
gives ``{"step", "master", <slots>}`` keyed by parameter name (float32
master weights for bf16 / f16 parameters under ``multi_precision``, float32
slots), and ``new_params, new_state = opt.update(grads, state, params)``
applies ``grad_clip`` (one of the ``clip`` classes) first, then each
optimizer's rule with the decay mask of ``apply_decay_param_fun`` and the
learning rate (a float or an ``lr.LRScheduler``, evaluated at the state's
step).

The torch idiom: where the reference donates the old parameters and state
to its jitted step, :meth:`Optimizer.apply` (and ``step()`` on a bound
module) updates the parameters and the state **in place**, one parameter
at a time (its gradient clipped there too), so no second copy of the
parameters, the state or the gradients exists.  The update is plain
elementwise PyTorch, as the reference leaves it to XLA's fusion.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from . import lr as lr_mod
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adamax", "RMSProp", "Lamb",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "lr"]

lr = lr_mod

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _lr_value(learning_rate, step) -> float:
    if isinstance(learning_rate, lr_mod.LRScheduler):
        return learning_rate.value(step)
    return float(learning_rate)


def _pow32(base: float, t: float, like: torch.Tensor) -> torch.Tensor:
    """``base ** t`` in float32 on ``like``'s device (the reference raises
    a weakly typed float to its float32 step)."""
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=like.device), float(t))


class Optimizer:
    """Base optimizer.

    ``parameters`` may be an ``nn.Module`` (the imperative API: ``step()``
    updates its trainable parameters in place) or omitted (the functional
    API on explicit ``{name: tensor}`` dicts)."""

    def __init__(self, learning_rate=0.001,
                 parameters: Optional[nn.Module] = None,
                 weight_decay: float = 0.0,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None, multi_precision: bool = True):
        self._lr = learning_rate
        self._model = parameters if isinstance(parameters, nn.Module) else None
        self.weight_decay = float(weight_decay)
        self.apply_decay_param_fun = apply_decay_param_fun
        self.grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._state = None

    # -- functional core ----------------------------------------------------

    @torch.no_grad()
    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"step": 0}
        if self._multi_precision:
            state["master"] = {k: v.detach().float().clone()
                               for k, v in params.items()
                               if v.dtype in _LOW_PRECISION}
        for slot in self._slot_names():
            state[slot] = {k: torch.zeros(v.shape, dtype=torch.float32,
                                          device=v.device)
                           for k, v in params.items()}
        return state

    def _slot_names(self):
        return ()

    def _decay_mask(self, params):
        if self.weight_decay == 0.0:
            return {k: 0.0 for k in params}
        if self.apply_decay_param_fun is None:
            return {k: 1.0 for k in params}
        return {k: (1.0 if self.apply_decay_param_fun(k) else 0.0)
                for k in params}

    def _updates(self, grads, state, params):
        """Yield (name, new float32 value, new slots) for every parameter
        with a gradient, the clip applied first, one gradient at a time."""
        clip = (self.grad_clip.per_tensor(grads)
                if self.grad_clip is not None else None)
        step = state["step"] + 1
        lr_t = _lr_value(self._lr, state["step"])
        master = state.get("master", {})
        decay = self._decay_mask(params)
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            if clip is not None:
                g = clip(g)
            slots = {s: state[s][k] for s in self._slot_names()}
            p32 = master.get(k, p).detach().float()
            p32_new, slots_new = self._apply_one(k, p32, g.float(), lr_t,
                                                 step, decay[k], slots)
            yield k, p32_new, slots_new

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]):
        """Returns (new_params, new_state); the inputs are left as they
        are.  A parameter without a gradient keeps its value and slots."""
        new_params = dict(params)
        new_state = {"step": state["step"] + 1}
        for s in self._slot_names():
            new_state[s] = dict(state[s])
        if "master" in state:
            new_state["master"] = dict(state["master"])
        for k, p32_new, slots_new in self._updates(grads, state, params):
            new_params[k] = p32_new.to(params[k].dtype)
            for s, v in slots_new.items():
                new_state[s][k] = v
            if k in state.get("master", {}):
                new_state["master"][k] = p32_new
        return new_params, new_state

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        """Return (new_p32, new_slots_for_this_param)."""
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor]) -> None:
        """One update of ``params`` (``{name: tensor}``, e.g. a module's
        trainable parameters) and of this optimizer's state, both in place;
        the state is initialised from ``params`` at the first call."""
        if self._state is None:
            self._state = self.init(params)
        st = self._state
        master = st.get("master", {})
        for k, p32_new, slots_new in self._updates(grads, st, params):
            params[k].copy_(p32_new)
            if k in master:
                master[k] = p32_new
            for s, v in slots_new.items():
                st[s][k] = v
        st["step"] += 1

    # -- imperative mirror (reference API) -----------------------------------

    def _require_model(self) -> nn.Module:
        if self._model is None:
            raise RuntimeError(
                "imperative API needs Optimizer(parameters=<nn.Module>)")
        return self._model

    def bind(self, model: nn.Module) -> None:
        """Bind the imperative API to ``model``'s trainable parameters."""
        self._model = model

    def trainable(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self._require_model().named_parameters()
                if p.requires_grad}

    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Apply one update to the bound module, in place; ``grads``
        defaults to the parameters' ``.grad``."""
        params = self.trainable()
        if grads is None:
            grads = {k: p.grad for k, p in params.items()
                     if p.grad is not None}
        self.apply(grads, params)

    def clear_grad(self) -> None:
        for p in self._require_model().parameters():
            p.grad = None

    def get_lr(self) -> float:
        step = self._state["step"] if self._state is not None else 0
        return _lr_value(self._lr, step)

    def state_dict(self):
        return self._state

    def set_state_dict(self, state):
        self._state = state


class SGD(Optimizer):
    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        g32 = g32 + self.weight_decay * decay_on * p32
        return p32 - lr_t * g32, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = float(momentum)
        self.use_nesterov = use_nesterov

    def _slot_names(self):
        return ("velocity",)

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        g32 = g32 + self.weight_decay * decay_on * p32
        vel = self.momentum * slots["velocity"] + g32
        if self.use_nesterov:
            p_new = p32 - lr_t * (g32 + self.momentum * vel)
        else:
            p_new = p32 - lr_t * vel
        return p_new, {"velocity": vel}


class Adam(Optimizer):
    """Adam with L2-style decay folded into the gradient (reference Adam
    semantics); see :class:`AdamW` for decoupled decay."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _slot_names(self):
        return ("moment1", "moment2")

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        if not self._decoupled:
            g32 = g32 + self.weight_decay * decay_on * p32
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * g32
        v = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(
            g32)
        mhat = m / (1 - _pow32(self.beta1, step, m))
        vhat = v / (1 - _pow32(self.beta2, step, v))
        upd = mhat / (torch.sqrt(vhat) + self.epsilon)
        if self._decoupled:
            upd = upd + self.weight_decay * decay_on * p32
        return p32 - lr_t * upd, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay (parity: ``paddle.optimizer.AdamW``)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay: float = 0.01, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, weight_decay=weight_decay, **kw)


class Adagrad(Optimizer):
    """Parity: ``paddle.optimizer.Adagrad``."""

    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 initial_accumulator_value: float = 0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _slot_names(self):
        return ("moment",)

    def init(self, params):
        state = super().init(params)
        if self.initial_accumulator_value:
            for v in state["moment"].values():
                v.fill_(self.initial_accumulator_value)
        return state

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        g32 = g32 + self.weight_decay * decay_on * p32
        acc = slots["moment"] + torch.square(g32)
        return (p32 - lr_t * g32 / (torch.sqrt(acc) + self.epsilon),
                {"moment": acc})


class Adamax(Optimizer):
    """Adam with the infinity norm (parity: ``paddle.optimizer.Adamax``)."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _slot_names(self):
        return ("moment", "inf_norm")

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        g32 = g32 + self.weight_decay * decay_on * p32
        m = self.beta1 * slots["moment"] + (1 - self.beta1) * g32
        u = torch.maximum(self.beta2 * slots["inf_norm"], torch.abs(g32))
        p_new = p32 - (lr_t / (1 - _pow32(self.beta1, step, m))) * m / (
            u + self.epsilon)
        return p_new, {"moment": m, "inf_norm": u}


class RMSProp(Optimizer):
    """Parity: ``paddle.optimizer.RMSProp`` (rho/momentum/centered knobs)."""

    def __init__(self, learning_rate=0.001, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _slot_names(self):
        names = ["mean_square", "velocity"]
        if self.centered:
            names.append("mean_grad")
        return tuple(names)

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        g32 = g32 + self.weight_decay * decay_on * p32
        ms = self.rho * slots["mean_square"] + (1 - self.rho) * torch.square(
            g32)
        out = {"mean_square": ms}
        denom = ms
        if self.centered:
            mg = self.rho * slots["mean_grad"] + (1 - self.rho) * g32
            out["mean_grad"] = mg
            denom = ms - torch.square(mg)
        upd = g32 / torch.sqrt(denom + self.epsilon)
        vel = self.momentum * slots["velocity"] + lr_t * upd
        out["velocity"] = vel
        return p32 - vel, out


class Lamb(Optimizer):
    """Layer-wise adaptive large-batch optimizer (parity:
    ``paddle.optimizer.Lamb``): the LAMB trust-ratio scaling of the AdamW
    update, per parameter tensor."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6,
                 exclude_from_weight_decay_fn: Optional[
                     Callable[[str], bool]] = None, **kw):
        super().__init__(learning_rate, weight_decay=lamb_weight_decay, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._exclude = exclude_from_weight_decay_fn

    def _slot_names(self):
        return ("moment1", "moment2")

    def _apply_one(self, name, p32, g32, lr_t, step, decay_on, slots):
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * g32
        v = self.beta2 * slots["moment2"] + (1 - self.beta2) * torch.square(
            g32)
        mhat = m / (1 - _pow32(self.beta1, step, m))
        vhat = v / (1 - _pow32(self.beta2, step, v))
        r = mhat / (torch.sqrt(vhat) + self.epsilon)
        # both exemption knobs, as in the reference
        if not (self._exclude is not None and self._exclude(name)):
            r = r + self.weight_decay * decay_on * p32
        p_norm = torch.sqrt(torch.sum(torch.square(p32)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        return p32 - lr_t * ratio * r, {"moment1": m, "moment2": v}
