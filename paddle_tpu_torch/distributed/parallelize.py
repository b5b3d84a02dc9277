"""The train step on one device (mirrors
``paddle_tpu/distributed/parallelize.py``).

The reference builds its hybrid-parallel step as one jitted program that
donates the old parameters and optimizer state.  The port runs it eagerly
on one GPU and updates the module's parameters and the optimizer's state
in place (:meth:`paddle_tpu_torch.optimizer.Optimizer.apply`).  Meshes of
more than one device (ZeRO, tensor, pipeline and context parallelism) are
ROADMAP A9/A10 and raise.  An enabled ``amp.GradScaler`` scales the loss
as the reference's step does (:func:`build_train_step`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..flags import flag

__all__ = ["build_train_step", "build_eval_step"]


def _default_loss_fn(model: nn.Module, batch: Dict[str, Any]):
    return model.compute_loss(**batch)


def _one_device(hcg) -> None:
    """Refuse a mesh of more than one device.  ``hcg``: None, a mapping of
    axis -> degree, or an object whose ``shape`` (or ``mesh.shape``) is one
    (the reference's ``HybridCommunicateGroup`` and ``Mesh``)."""
    if hcg is None:
        return
    shape = getattr(getattr(hcg, "mesh", hcg), "shape", hcg)
    degrees = {str(k): int(v) for k, v in dict(shape).items()}
    if any(d > 1 for d in degrees.values()):
        raise NotImplementedError(
            f"build_train_step: mesh degrees {degrees}: training across "
            f"devices (ZeRO / tensor / pipeline / context parallelism) is "
            f"ROADMAP A9/A10, not ported")


def _raise_on_nonfinite(grads: Dict[str, torch.Tensor]) -> None:
    bad = [k for k, g in grads.items()
           if not bool(torch.isfinite(g).all().item())]
    if bad:
        raise FloatingPointError(
            f"check_nan_inf: non-finite gradient detected ({bad[:4]})")


def build_train_step(model: nn.Module, optimizer,
                     loss_fn: Optional[Callable[[nn.Module, Dict[str, Any]],
                                                Any]] = None,
                     hcg=None, grad_accum_steps: int = 1, scaler=None):
    """Build the single-device train step.

    Returns ``step_fn(batch) -> loss``: forward and backward of
    ``loss_fn(model, batch)`` (default ``model.compute_loss(**batch)``),
    then ``optimizer`` updates the model's trainable parameters and its
    state in place (the optimizer is bound to ``model``).  ``batch`` is a
    dict of tensors on the model's device, leading dim = the batch.

    ``grad_accum_steps > 1`` splits the batch into that many equal
    micro-batches in order and accumulates float32 gradients, each divided
    by ``grad_accum_steps`` (the reference's scan, :186-201); the returned
    loss is the mean of the micro-batch losses.  With the
    ``check_nan_inf`` flag set, a non-finite gradient raises
    ``FloatingPointError`` before the update.

    ``scaler``, an enabled :class:`paddle_tpu_torch.amp.GradScaler`, runs
    the reference's float16 step (:171-216): the gradients are those of
    the float32 loss times the scale (accumulated in float32 over
    micro-batches as above), then unscaled (``unscale_with``), then
    checked by ``check_nan_inf`` if set; where any is not finite the
    whole update is skipped -- parameters, float32 masters, moments and
    the optimizer's step counter (so the lr schedule) stay as they were
    -- and ``update_state`` shrinks the scale, else it counts a good
    step.  The scaler's state lives on the scaler (``loss_scaling``,
    ``_state``), where the reference keeps it in ``opt_state``.  The
    returned loss is the unscaled one.  The step reads ``found_inf``
    back to the host once, to choose between the two: this eager step
    synchronises there, once a step."""
    _one_device(hcg)
    use_scaler = scaler is not None and scaler.is_enable()
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    loss_fn = loss_fn or _default_loss_fn
    optimizer.bind(model)
    n = int(grad_accum_steps)

    def scaled(loss, state):
        return scaler.scale_with(state, loss) if use_scaler else loss

    def step(batch: Dict[str, Any]) -> torch.Tensor:
        params = optimizer.trainable()
        names, tensors = list(params), list(params.values())
        state = scaler._state if use_scaler else None
        if n == 1:
            loss = loss_fn(model, batch)
            grads = dict(zip(names, torch.autograd.grad(scaled(loss, state),
                                                        tensors)))
            loss = loss.detach()
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n} micro-batches")
            m = rows // n
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            losses = []
            for i in range(n):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                loss = loss_fn(model, mb)
                for k, g in zip(names, torch.autograd.grad(
                        scaled(loss, state), tensors)):
                    grads[k].add_(g.float() / n)
                losses.append(loss.detach())
            loss = torch.stack(losses).mean()
        if use_scaler:
            grads, found_inf = scaler.unscale_with(state, grads)
        if flag("check_nan_inf"):
            _raise_on_nonfinite(grads)
        if use_scaler:
            skip = bool(found_inf)      # the step's one host read
            scaler._state = scaler.update_state(state, skip)
            if skip:
                return loss
        optimizer.apply(grads, params)
        return loss

    return step


def build_eval_step(model: nn.Module, hcg=None,
                    fn: Optional[Callable] = None):
    """No-grad forward in eval mode: ``run(batch) -> fn(model, batch)``
    (default ``model(**batch)``); the module's mode is restored after."""
    _one_device(hcg)
    fn = fn or (lambda m, batch: m(**batch))

    def run(batch):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return fn(model, batch)
        finally:
            model.train(was_training)

    return run
