#!/usr/bin/env python3
"""Time every bf16 forward attention build at the head dims the serving
phases run, the float32 and float16 builds at head_dim 128, and the
backward K5 / K6 at the head dims the training phases run, on one NVIDIA
GPU, for one or more checkouts of the repository in turns.

Run from the repository root::

    python3 chip_head_dims.py [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory holding
``paddle_tpu_torch/``, for example the parent commit unpacked with ``git
archive`` into a git-ignored directory; give A B B A to compare two in
turns on one card.  Each runs in its own process and prints one JSON line:
for each head dim and build, the device time of one call (torch.profiler:
the sum of the kernels a call launches, over 100 calls cycling input
copies past the 50 MB L2 cache; a decode call enqueues slower than the
card runs it, so CUDA events around the loop would time the host), in
microseconds, and the largest error against the plain version, or the
error a checkout raises for a head dim it does not take.  The shapes are
``chip_smoke.py``'s main rows:

  D 128   Llama-3-8B (Hq 32, Hkv 8): the K1 family at the decode tick (B 8,
          L 4096, pos spread; int8 in 128-token granules, paged in
          128-token blocks); K2 causal B 4 x 2048; K2-paged(-int8) B 4 x
          2048 over 4096 keys in 128-token blocks;
  D 64    TinyLlama-1.1B (Hq 32, Hkv 4): the K1 family at B 8, L 2048
          (paged in 64-token blocks); K2-paged(-int8) B 4 x 512 over 2048
          keys in 64-token blocks;
  D 256   a Llama at Gemma-2B's widths (Hq 8, Hkv 1): as D 64, and K2
          causal B 4 x 2048;
  D 128 float32 / float16 / bf16 G 1   ``LlamaConfig()`` and Llama-2-7B
          (Hq = Hkv = 32): as D 64, and K2 causal B 4 x 2048 (a checkout
          without a build reports the refusal; bf16 at the same shape is
          the float16 rows' twin);
  D 256 float32 / D 64 float32   the Gemma-2B-wide Llama (Hq 8, Hkv 1)
          and TinyLlama (Hq 32, Hkv 4) at float32
          (``training_f32_d256``, ``serving_f32_tinyllama``): as D 64, and
          K2 causal B 4 x 2048.

and K5 (dq) / K6 (dk, dv) on inputs whose out and lse come from K2 (the
error: against ``flash_attention_bwd_reference``, dk and dv together):

  D 128   Llama-3-8B's training micro-batch (Hq 32, Hkv 8), causal B 2 x
          2048;
  D 72    DiT-XL/2's train step (16 heads), not causal, B 32 x 256;
  D 256   the Gemma-2B-wide Llama (Hq 8, Hkv 1), causal B 4 x 2048;

and at float32 (20 calls each) D 256 as above and D 96 at TinyLlama's
heads (Hq 32, Hkv 4), causal B 4 x 2048 (``training_f32_d256``'s and
phase 2's ``/f32`` training rows).

Tables and inputs come from fixed seeds.  The first line is the card's name
and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
POS = [0, 4095, 17, 1000, 2047, 3000, 511, 128]
# label -> (dtype, head_dim, Hq, Hkv, L, block_len, K2-paged s, K2
# contiguous S)
SHAPES = {"D 128": ("bfloat16", 128, 32, 8, 4096, 128, 2048, 2048),
          "D 64": ("bfloat16", 64, 32, 4, 2048, 64, 512, None),
          "D 256": ("bfloat16", 256, 8, 1, 2048, 64, 512, 2048),
          "D 128 float32": ("float32", 128, 32, 32, 2048, 64, 512, 2048),
          "D 128 float16": ("float16", 128, 32, 32, 2048, 64, 512, 2048),
          "D 128 bf16 G 1": ("bfloat16", 128, 32, 32, 2048, 64, 512, 2048),
          "D 256 float32": ("float32", 256, 8, 1, 2048, 64, 512, 2048),
          "D 64 float32": ("float32", 64, 32, 4, 2048, 64, 512, 2048)}
# head_dim -> (B, S, Hq, Hkv, causal) of the K5 / K6 rows
BWD_SHAPES = {128: (2, 2048, 32, 8, True),
              72: (32, 256, 16, 16, False),
              256: (4, 2048, 8, 1, True)}
# and of the float32 K5 / K6 rows (20 calls each)
BWD_SHAPES_F32 = {256: (4, 2048, 8, 1, True),
                  96: (4, 2048, 32, 4, True)}


def measure(checkout: str) -> dict:
    """The JSON line of one checkout (run in a process of its own)."""
    sys.path.insert(0, checkout)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import (cached_decode_attention_reference,
                                      decode_attention_cuda,
                                      decode_attention_int8_cuda,
                                      decode_attention_paged_cuda,
                                      decode_attention_paged_int8_cuda,
                                      flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_reference,
                                      flash_attention_fwd_cuda,
                                      flash_attention_fwd_paged_cuda,
                                      flash_attention_fwd_paged_int8_cuda,
                                      flash_attention_reference)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return 0.002 + 0.02 * torch.rand(shape, generator=gen, device=dev)

    def n_copies(nbytes):
        return int(min(8, max(2, math.ceil(150e6 / nbytes))))

    def device_us(fns, n=100):
        for f in fns:
            f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.key:
                t = getattr(ev, "device_time_total", None)
                total += getattr(ev, "cuda_time_total", 0.0) if t is None \
                    else t
        return round(total / n, 3)

    def row(make, fn, plain, nbytes, view=lambda x: x, n=100):
        """``view`` turns fn's result into the tensor held against
        ``plain``'s (outside the timed calls)."""
        try:
            sets = [make() for _ in range(n_copies(nbytes))]
            got = view(fn(sets[0]))
            torch.cuda.synchronize()
        except (NotImplementedError, RuntimeError) as e:
            return {"refused": str(e).splitlines()[0][:160]}
        err = (got.float() - plain(sets[0]).float()).abs().max().item()
        return {"us": device_us([lambda t=t: fn(t) for t in sets], n),
                "max_err": round(err, 6)}

    out = {"checkout": checkout}
    for label, (dt, d, hq, hkv, L, bl, s_paged, s_k2) in SHAPES.items():
        dt = getattr(torch, dt)
        esz = 4 if dt == torch.float32 else 2

        def randq(*shape, dt=dt):
            return randn(*shape, dtype=dt)
        res = {}
        b = len(POS)
        pos = torch.tensor([min(p, L - 1) for p in POS], dtype=torch.int32,
                           device=dev)
        mb = L // bl
        n_pool = b * mb + 1
        perm = torch.randperm(n_pool - 1,
                              generator=torch.Generator().manual_seed(d)) + 1
        tables = perm.view(b, mb).to(torch.int32).to(dev)
        cache_bytes = 2 * b * L * hkv * d * esz
        res["K1"] = row(
            lambda: (randq(b, 1, hq, d), randq(b, L, hkv, d),
                     randq(b, L, hkv, d)),
            lambda t: decode_attention_cuda(t[0], t[1], t[2], pos),
            lambda t: cached_decode_attention_reference(t[0], t[1], t[2],
                                                        pos), cache_bytes)
        res["K1-int8"] = row(
            lambda: (randq(b, 1, hq, d), int8(b, L, hkv, d),
                     int8(b, L, hkv, d), scales(b, L // 128, hkv),
                     scales(b, L // 128, hkv)),
            lambda t: decode_attention_int8_cuda(t[0], t[1], t[2], pos, t[3],
                                                 t[4]),
            lambda t: cached_decode_attention_reference(
                t[0], t[1], t[2], pos, k_scale=t[3], v_scale=t[4]),
            cache_bytes // 2)
        res["K1-paged"] = row(
            lambda: (randq(b, 1, hq, d), randq(n_pool, bl, hkv, d),
                     randq(n_pool, bl, hkv, d)),
            lambda t: decode_attention_paged_cuda(t[0], t[1], t[2], pos,
                                                  tables),
            lambda t: cached_decode_attention_reference(
                t[0], t[1], t[2], pos, block_tables=tables), cache_bytes)
        res["K1-paged-int8"] = row(
            lambda: (randq(b, 1, hq, d), int8(n_pool, bl, hkv, d),
                     int8(n_pool, bl, hkv, d), scales(n_pool, hkv),
                     scales(n_pool, hkv)),
            lambda t: decode_attention_paged_int8_cuda(
                t[0], t[1], t[2], pos, tables, t[3], t[4]),
            lambda t: cached_decode_attention_reference(
                t[0], t[1], t[2], pos, block_tables=tables, k_scale=t[3],
                v_scale=t[4]), cache_bytes // 2)
        # the suffix prefill: 4 rows of s_paged queries at spread offsets
        pb = 4
        ppos = torch.tensor([0, L // 16, L // 2, L - s_paged],
                            dtype=torch.int32, device=dev)
        res["K2-paged"] = row(
            lambda: (randq(pb, s_paged, hq, d), randq(n_pool, bl, hkv, d),
                     randq(n_pool, bl, hkv, d)),
            lambda t: flash_attention_fwd_paged_cuda(t[0], t[1], t[2], ppos,
                                                     tables[:pb]),
            lambda t: cached_decode_attention_reference(
                t[0], t[1], t[2], ppos, block_tables=tables[:pb]),
            cache_bytes)
        res["K2-paged-int8"] = row(
            lambda: (randq(pb, s_paged, hq, d), int8(n_pool, bl, hkv, d),
                     int8(n_pool, bl, hkv, d), scales(n_pool, hkv),
                     scales(n_pool, hkv)),
            lambda t: flash_attention_fwd_paged_int8_cuda(
                t[0], t[1], t[2], ppos, tables[:pb], t[3], t[4]),
            lambda t: cached_decode_attention_reference(
                t[0], t[1], t[2], ppos, block_tables=tables[:pb],
                k_scale=t[3], v_scale=t[4]), cache_bytes // 2)
        if s_k2:
            res["K2"] = row(
                lambda: (randq(4, s_k2, hq, d), randq(4, s_k2, hkv, d),
                         randq(4, s_k2, hkv, d)),
                lambda t: flash_attention_fwd_cuda(t[0], t[1], t[2],
                                                   causal=True)[0],
                lambda t: flash_attention_reference(t[0], t[1], t[2],
                                                    causal=True)[0],
                3 * 4 * s_k2 * hq * d * esz)
        out[label] = res
        torch.cuda.empty_cache()
    for d, (b, s, hq, hkv, causal) in BWD_SHAPES.items():

        def make():
            q, k, v, do = (randn(b, s, hq, d), randn(b, s, hkv, d),
                           randn(b, s, hkv, d), randn(b, s, hq, d))
            o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
            return q, k, v, do, lse, delta.contiguous(), o

        def plain(t, i):
            got = flash_attention_bwd_reference(t[0], t[1], t[2], t[6], t[4],
                                                t[3], causal=causal)
            return got[0] if i == 0 else torch.cat(got[1:])

        nbytes = 2 * b * s * (2 * hq + 2 * hkv) * d
        out[f"D {d} backward"] = {
            "K5": row(make, lambda t: flash_attention_bwd_dq_cuda(
                *t[:6], causal=causal), lambda t: plain(t, 0), nbytes),
            "K6": row(make, lambda t: flash_attention_bwd_dkv_cuda(
                *t[:6], causal=causal), lambda t: plain(t, 1), nbytes,
                view=torch.cat)}
        torch.cuda.empty_cache()
    for d, (b, s, hq, hkv, causal) in BWD_SHAPES_F32.items():

        def make():
            f32 = torch.float32
            q, k, v, do = (randn(b, s, hq, d, dtype=f32),
                           randn(b, s, hkv, d, dtype=f32),
                           randn(b, s, hkv, d, dtype=f32),
                           randn(b, s, hq, d, dtype=f32))
            o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal)
            delta = (do * o).sum(-1).transpose(1, 2)
            return q, k, v, do, lse, delta.contiguous(), o

        def plain(t, i):
            got = flash_attention_bwd_reference(t[0], t[1], t[2], t[6], t[4],
                                                t[3], causal=causal)
            return got[0] if i == 0 else torch.cat(got[1:])

        nbytes = 4 * b * s * (2 * hq + 2 * hkv) * d
        out[f"D {d} float32 backward"] = {
            "K5": row(make, lambda t: flash_attention_bwd_dq_cuda(
                *t[:6], causal=causal), lambda t: plain(t, 0), nbytes,
                n=20),
            "K6": row(make, lambda t: flash_attention_bwd_dkv_cuda(
                *t[:6], causal=causal), lambda t: plain(t, 1), nbytes,
                view=torch.cat, n=20)}
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps(measure(args[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_head_dims: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for checkout in args or [str(ROOT)]:
        if not (Path(checkout) / "paddle_tpu_torch").is_dir():
            print(f"chip_head_dims: no paddle_tpu_torch/ in {checkout}",
                  file=sys.stderr)
            return 2
        r = subprocess.run([sys.executable, __file__, "--measure",
                            str(Path(checkout).resolve())],
                           capture_output=True, text=True, timeout=900)
        print(r.stdout.strip() or json.dumps(
            {"checkout": checkout, "error": r.stderr.strip()[-400:]}),
            flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
