#!/usr/bin/env python3
"""How far the float32 flash backward (K5 dq, K6 dk / dv), the float32
flash forward (K2 out and lse) and their float32 plain versions each lie
from the plain versions computed in float64, at the training
micro-batch's shapes, on one NVIDIA GPU.

Run from the repository root::

    python3 chip_f32_bwd_accuracy.py

For each float32 head dim of phase 2 (64, 72, 96, 128, 136, 192, 200 and
256; every one runs the 3xTF32 kernels of ``csrc/flash_attention_bwd.cu``
and ``csrc/flash_attention_fwd.cu``) at B 4 x 2048 causal and B 2 x 2048
packed, with TinyLlama's 32 / 4 heads up to 128 and 8 / 1 above, it prints
one JSON line: per gradient and for K2's out and lse (the rows that see a
key), the largest absolute difference of the kernel from the float32
plain version, of the kernel from the float64 one, and of the float32
plain version from the float64 one, each also as its largest ratio to the
phase-2 bar atol 1e-5 + rtol 1e-5 |float64 value| (lse: 1e-5 absolute; a
ratio above 1 fails the bar).  dk / dv sum G x Sq terms a key (16384 at B
4 x 2048, G 8), so the order of float32 sums shows there; the kernels sum
each 64-query tile apart (ROADMAP C6).
The first line names the card and its power limit.  Exits non-zero
without a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

DIMS = (64, 72, 96, 128, 136, 192, 200, 256)
SEQ = 2048


def stats(got, want, rtol=1e-5):
    """Largest |got - want| and its largest ratio to the bar."""
    e = (got.double() - want.double()).abs()
    bar = 1e-5 + rtol * want.double().abs()
    return {"max_abs": float(e.max()), "max_ratio_to_bar": float((e / bar)
                                                                 .max())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_f32_bwd_accuracy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import packed_segments
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_reference,
                                      flash_attention_fwd_cuda,
                                      flash_attention_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    import subprocess
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": limit.strip()}), flush=True)
    for d in DIMS:
        hq, hkv = (32, 4) if d <= 128 else (8, 1)
        for b, packed in ((4, False), (2, True)):
            q, k, v, do = (randn(b, SEQ, hq, d), randn(b, SEQ, hkv, d),
                           randn(b, SEQ, hkv, d), randn(b, SEQ, hq, d))
            dlse = randn(b, hq, SEQ)
            kw = {"causal": True}
            if packed:
                kw["segment_ids"] = torch.from_numpy(
                    packed_segments(b, SEQ, seed=SEQ)).to(dev)
            out, lse = flash_attention_fwd_cuda(q, k, v, **kw)
            delta = ((do * out).sum(-1).transpose(1, 2) - dlse).contiguous()
            got = (flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw),
                   *flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 **kw))
            plain = flash_attention_bwd_reference(q, k, v, out, lse, do, dlse,
                                                  **kw)
            exact = flash_attention_bwd_reference(
                *(t.double() for t in (q, k, v, out, lse, do, dlse)), **kw)
            line = {"head_dim": d, "batch": b, "seq": SEQ, "heads": [hq, hkv],
                    "packed": packed}
            # K2: out, and lse over the rows that see a key
            fplain = flash_attention_reference(q, k, v, **kw)
            fexact = flash_attention_reference(q.double(), k.double(),
                                               v.double(), **kw)
            live = fexact[1] > -1e29
            for name, i, rtol in (("out", 0, 1e-5), ("lse", 1, 0.0)):
                g, p, x = ((t[i][live] if i else t[i])
                           for t in ((out, lse), fplain, fexact))
                line[name] = {"kernel_vs_f32_plain": stats(g, p, rtol),
                              "kernel_vs_f64": stats(g, x, rtol),
                              "f32_plain_vs_f64": stats(p, x, rtol)}
            del fplain, fexact
            for name, g, p, x in zip(("dq", "dk", "dv"), got, plain, exact):
                line[name] = {"kernel_vs_f32_plain": stats(g, p),
                              "kernel_vs_f64": stats(g, x),
                              "f32_plain_vs_f64": stats(p, x)}
            print(json.dumps(line), flush=True)
            del q, k, v, do, out, lse, delta, got, plain, exact
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
