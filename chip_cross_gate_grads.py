#!/usr/bin/env python3
"""Where the error of Qwen2-VL's cross-attention gate gradients comes
from, on one NVIDIA GPU.

Run from the repository root::

    python3 chip_cross_gate_grads.py [--seeds N]

A cross layer adds ``tanh(gate) * y`` to the residual stream, so its
one-element gate's gradient is ONE sum, ``sech^2(gate) * sum(y * dL/dout)``
over every element of the layer's output.  For seed s in 0..N-1 (default
8) the script builds chip_smoke.py's ``qwen2_vl_train`` model
(``Qwen2VLConfig()`` widths, bf16, cross gates 0.5, weights seeded with s)
and batch (4 images, 64-token prompts, seeded with 100 + s) and prints one
``seed`` line: each gate's step-1 gradient as relative error against a
float32 copy of the weights on the plain path, for

  kernel      K2 / K5 / K6 (the train step's path);
  plain       the plain versions (``reference_mode()``: float32 softmax);
  plain_p16   the plain versions with P = exp(S - rowmax) rounded to bf16
              before P.V, as K2 rounds it (the row sum stays float32;
              the gradient passes the rounding unchanged),

beside the summed relative L2 error over every tensor on each path, and
the cancellation of the gate's sum on the float32 copy:
``|sum(terms)| / sum(|terms|)``, terms = y * dL/dout.

Then one ``attention`` line a seed: one attention call at the cross
layers' shape (B 4, 64 text queries over 256 patches, 8 heads of 128,
not causal, bf16, seeded inputs and output gradient), out / dq / dk / dv
as relative L2 error against the float32 plain version on the same
bf16-valued inputs: the kernels (K2, K5, K6), the plain version and the
plain version with P rounded to bf16.  The first line is the card's name
and power limit; the last a ``summary`` of each ratio's smallest and
largest reading over the seeds.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import copy
import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = dict(b=4, sq=64, skv=256, h=8, d=128)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def p_rounded_to_bf16(torch):
    """The plain attention with K2's rounding of P: ``ops.attention``'s
    plain forward replaced by one that rounds the unnormalised
    probabilities to the inputs' dtype before the product with V (forward
    value only: the gradient passes the rounding unchanged)."""
    from paddle_tpu_torch.ops import attention
    saved = attention.flash_attention_reference

    def plain_p16(q, k, v, attn_mask=None, causal=False, scale=None,
                  return_lse=True, segment_ids=None, kv_segment_ids=None):
        if attn_mask is not None:
            raise NotImplementedError("plain_p16 takes no attn_mask")
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        scale = d ** -0.5 if scale is None else scale
        kf = attention._repeat_kv(k, hq // hkv).transpose(1, 2).float()
        vf = attention._repeat_kv(v, hq // hkv).transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk",
                         q.transpose(1, 2).float() * scale, kf)
        keep = attention._keep_mask(sq, skv, causal, segment_ids,
                                    kv_segment_ids, q.device)
        if keep is not None:
            s = s.masked_fill(~keep, attention.NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        p16 = p + (p.to(q.dtype).float() - p).detach()
        out = torch.einsum("bhqk,bhkd->bhqd", p16, vf) / l
        lse = (m + torch.log(l)).squeeze(-1)
        out = out.transpose(1, 2).to(q.dtype)
        return (out, lse) if return_lse else out

    attention.flash_attention_reference = plain_p16
    try:
        yield
    finally:
        attention.flash_attention_reference = saved


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def model_seed(torch, seed: int, dev="cuda", cfg=None) -> dict:
    """The ``seed`` line: gate-gradient errors on each path (``cfg``:
    ``Qwen2VLConfig()`` in bf16 unless given)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    from paddle_tpu_torch.models import Qwen2VLConfig
    from paddle_tpu_torch.ops._dispatch import reference_mode
    dev = torch.device(dev)
    cfg = cfg or Qwen2VLConfig(dtype="bfloat16")
    m = chip_smoke._qwen_model(torch, cfg, dev, seed=seed)
    m.train()
    batch = chip_smoke.qwen_batch(torch, cfg, chip_smoke.QWEN_BATCH,
                                  chip_smoke.QWEN_PROMPT, 100 + seed, dev)
    names = [n for n, _ in m.named_parameters()]
    gates = [i for i, p in enumerate(m.parameters()) if p.numel() == 1]

    def grads(mod):
        loss = mod.compute_loss(**batch)
        return torch.autograd.grad(loss, list(mod.parameters()))

    # the float32 truth, with each cross layer's terms y * dL/dout
    m32 = copy.deepcopy(m).float()
    seen = []

    def hook(mod, inputs, out):
        y = (out - inputs[0]).detach()
        out.register_hook(lambda g, y=y: seen.append(y * g))

    handles = [c.register_forward_hook(hook) for c in m32.cross]
    with reference_mode():
        truth = grads(m32)
    for h in handles:
        h.remove()
    del m32
    # the backward meets the cross layers last to first
    cancel = [float(t.sum().abs() / t.abs().sum()) for t in seen[::-1]]
    del seen
    paths = {}
    for tag in ("kernel", "plain", "plain_p16"):
        ctx = (contextlib.nullcontext() if tag == "kernel"
               else reference_mode())
        p16 = (p_rounded_to_bf16(torch) if tag == "plain_p16"
               else contextlib.nullcontext())
        with ctx, p16:
            g = grads(m)
        err = sum(float((a.float() - t).pow(2).sum())
                  for a, t in zip(g, truth))
        paths[tag] = {
            "gates": {names[i]: rel(g[i], truth[i]) for i in gates},
            "summed_rel_l2": math.sqrt(err / sum(float(t.pow(2).sum())
                                                 for t in truth))}
        del g
    line = {"phase": "seed", "seed": seed,
            "gate_grad_f32": {names[i]: float(truth[i]) for i in gates},
            "cancellation": dict(zip((names[i] for i in gates), cancel)),
            **paths}
    del truth, m
    torch.cuda.empty_cache()
    return line


def attention_seed(torch, seed: int, dev="cuda") -> dict:
    """The ``attention`` line: one call at the cross layers' shape."""
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.ops._dispatch import reference_mode
    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + seed)
    b, sq, skv, h, d = (SHAPE[k] for k in ("b", "sq", "skv", "h", "d"))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = randn(b, sq, h, d), randn(b, skv, h, d), \
        randn(b, skv, h, d), randn(b, sq, h, d)

    def run(dtype):
        ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*ins)
        return [out.detach(), *torch.autograd.grad(out, ins, do.to(dtype))]

    with reference_mode():
        truth = run(torch.float32)
        plain = run(torch.bfloat16)
        with p_rounded_to_bf16(torch):
            p16 = run(torch.bfloat16)
    kernel = run(torch.bfloat16)
    parts = ("out", "dq", "dk", "dv")
    return {"phase": "attention", "seed": seed, "shape": SHAPE,
            **{tag: {n: rel(a, t) for n, a, t in zip(parts, res, truth)}
               for tag, res in (("kernel", kernel), ("plain", plain),
                                ("plain_p16", p16))}}


def summary(seeds, attn) -> dict:
    out = {}
    for gate in seeds[0]["kernel"]["gates"]:
        r = {}
        for num, den in (("kernel", "plain"), ("kernel", "plain_p16"),
                         ("plain_p16", "plain")):
            xs = [s[num]["gates"][gate] / s[den]["gates"][gate]
                  for s in seeds]
            r[f"{num}/{den}"] = [min(xs), max(xs)]
        for tag in ("kernel", "plain", "plain_p16"):
            xs = [s[tag]["gates"][gate] for s in seeds]
            r[tag] = [min(xs), max(xs)]
        xs = [s["cancellation"][gate] for s in seeds]
        r["cancellation"] = [min(xs), max(xs)]
        out[gate] = r
    xs = [s["kernel"]["summed_rel_l2"] / s["plain"]["summed_rel_l2"]
          for s in seeds]
    out["summed kernel/plain"] = [min(xs), max(xs)]
    for part in ("out", "dq", "dk", "dv"):
        for num, den in (("kernel", "plain"), ("kernel", "plain_p16")):
            xs = [a[num][part] / a[den][part] for a in attn]
            out[f"attention {part} {num}/{den}"] = [min(xs), max(xs)]
    return {"phase": "summary", "seeds": len(seeds), **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_cross_gate_grads: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    seeds, attn = [], []
    for s in range(args.seeds):
        seeds.append(model_seed(torch, s))
        emit(seeds[-1])
        attn.append(attention_seed(torch, s))
        emit(attn[-1])
    emit(summary(seeds, attn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
