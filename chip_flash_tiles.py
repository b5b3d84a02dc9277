#!/usr/bin/env python3
"""Time the flash kernels K5, K6 and K2 by tile mix on one NVIDIA GPU,
for one or more checkouts of the repository in turns.

Run from the repository root::

    python3 chip_flash_tiles.py [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory holding
``paddle_tpu_torch/``, for example the parent commit unpacked with ``git
archive`` into a git-ignored directory; give A B B A to compare two in
turns on one card.  Each runs in its own process and prints one JSON
line: the mean time of K5 (dq), K6 (dk, dv) and K2 (forward) over 30 warm
launches (CUDA events), in ms, at the training micro-batch's shape (B=2,
S=2048, Hq/Hkv 32/8, head_dim 128, bf16) under five segmentations with
the same inputs:

  causal           no ids;
  one-doc ids      ids all 0: the same kept and masked tiles as
                   ``causal``, so the difference is the segmented
                   build's own cost;
  packed           chip_smoke.py's packed rows (3-8 documents a row);
  16 docs of 128   documents aligned with the tiles;
  non-causal       no ids, every tile kept, none masked;

then ``ranges_ms``: the time of the torch work a wrapper does for segment
ids before its launch (K2's ``segment_tile_ranges`` of the query and of
the key ids, K5 / K6's ``backward_tile_ranges``) on the packed ids, which
runs on the card's stream inside the kernels' times above; then K2 and
K5 / K6 once at B=2, S=77 with packed ids (segment ids whose 1-d TMA
boxes start unaligned), reported as ``unaligned_ids``: "ok" or the CUDA
error.  The first line is the card's name and power limit.  Exits
non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, S, HQ, HKV, D = 2, 2048, 32, 8, 128


def packed_ids(torch, b, s, seed, lo=3, hi=8):
    """chip_smoke.py's packed_segments: lo..hi documents a row."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        n = min(rng.randint(lo, hi + 1), s)
        for c in sorted(rng.choice(np.arange(1, s), n - 1, replace=False)):
            out[r, c:] += 1
    return torch.from_numpy(out).cuda()


def measure(checkout: str) -> dict:
    """The JSON line of one checkout (run in a process of its own)."""
    sys.path.insert(0, checkout)
    import torch
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_fwd_cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def mean_ms(fn, n=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return round(start.elapsed_time(end) / n, 4)

    def kernels(q, k, v, do, **kw):
        out, lse = flash_attention_fwd_cuda(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        return (lambda: flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                    **kw),
                lambda: flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                     delta, **kw),
                lambda: flash_attention_fwd_cuda(q, k, v, **kw))

    q, k, v, do = randn(B, S, HQ, D), randn(B, S, HKV, D), \
        randn(B, S, HKV, D), randn(B, S, HQ, D)
    tiles = (torch.arange(S, device="cuda") // 128).int()
    mixes = {"causal": (True, None),
             "one-doc ids": (True, torch.zeros(B, S, dtype=torch.int32,
                                               device="cuda")),
             "packed": (True, packed_ids(torch, B, S, seed=S)),
             "16 docs of 128": (True, tiles[None].expand(B, S).contiguous()),
             "non-causal": (False, None)}
    row = {"checkout": checkout, "ms K5 K6 K2": {}}
    for name, (causal, seg) in mixes.items():
        fns = kernels(q, k, v, do, causal=causal, segment_ids=seg)
        row["ms K5 K6 K2"][name] = [mean_ms(f) for f in fns]
    from paddle_tpu_torch.ops.cuda import flash_attention as fwd
    from paddle_tpu_torch.ops.cuda import flash_attention_bwd as bwd
    ids = mixes["packed"][1]
    row["ranges_ms"] = {"K2": mean_ms(lambda: (
        fwd.segment_tile_ranges(ids), fwd.segment_tile_ranges(ids)))}
    if hasattr(bwd, "backward_tile_ranges"):   # absent before the change
        row["ranges_ms"]["K5, K6 each"] = mean_ms(
            lambda: bwd.backward_tile_ranges(ids))
    s = 77
    try:
        fns = kernels(randn(B, s, HQ, D), randn(B, s, HKV, D),
                      randn(B, s, HKV, D), randn(B, s, HQ, D), causal=True,
                      segment_ids=packed_ids(torch, B, s, seed=s))
        for f in fns:
            f()
        torch.cuda.synchronize()
        row["unaligned_ids"] = "ok"
    except RuntimeError as e:   # a fault in the kernel surfaces here
        row["unaligned_ids"] = str(e).splitlines()[0][:120]
    return row


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps(measure(args[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_tiles: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for checkout in args or [str(ROOT)]:
        if not (Path(checkout) / "paddle_tpu_torch").is_dir():
            print(f"chip_flash_tiles: no paddle_tpu_torch/ in {checkout}",
                  file=sys.stderr)
            return 2
        r = subprocess.run([sys.executable, __file__, "--measure",
                            str(Path(checkout).resolve())],
                           capture_output=True, text=True, timeout=600)
        print(r.stdout.strip() or json.dumps(
            {"checkout": checkout, "error": r.stderr.strip()[-400:]}),
            flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
