"""Training entry points of the port (mirrors ``paddle_tpu/distributed``):
the single-device train and eval steps.  Collectives, ZeRO, tensor,
pipeline and context parallelism are ROADMAP A9/A10."""

from .parallelize import build_eval_step, build_train_step

__all__ = ["build_eval_step", "build_train_step"]
