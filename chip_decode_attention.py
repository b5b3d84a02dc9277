#!/usr/bin/env python3
"""Time the decode tick's attention kernels on one NVIDIA GPU — K1 and
K1-int8 over the contiguous cache, K1-paged and K1-paged-int8 over the
pool — for one or more checkouts of the repository in turns.

Run from the repository root::

    python3 chip_decode_attention.py [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory holding
``paddle_tpu_torch/``, for example the parent commit unpacked with ``git
archive`` into a git-ignored directory; give A B B A to compare two in
turns on one card.  Each runs in its own process and prints one JSON
line.  For the bf16 build and the int8 build (B=8 s=1 Hq/Hkv 32/8
head_dim 128 unless named), at rows of ``chip_smoke.py``'s phase 2:

  main            paged: block_len 128, max_blocks 32, pos [0, 4095, 17,
                  1000, 2047, 3000, 511, 128] (360 of the 1024 split CTAs
                  hold a key);
  bl8             paged: B=7, block_len 8, max_blocks 512, pos [0, 7, 8,
                  255, 256, 257, 4095];
  all4095         paged: block_len 128, max_blocks 32, every row at pos
                  4095 (every split live, the merge's deepest case);
  contig main     contiguous (B, 4096, Hkv, D) cache (int8: 128-token
                  scale granules), main's pos;
  contig all4095  the same cache, every row at pos 4095;
  identity main   contig main's cache viewed as a pool of 128-token
                  blocks under the identity table (row b's blocks b * 32,
                  ..., b * 32 + 31; int8: its scales as (B * 32, Hkv)),
                  through the paged wrapper: the same function by the
                  paged kernel, to weigh the contiguous build's own
                  addressing against the table's;

it gives ``max_err`` against the plain version, ``device_us``: the
device time of one call (torch.profiler, the sum of every kernel a call
launches, over 200 calls cycling input copies past the L2 cache), and
``host_us``: the wall time to enqueue one call as [median, least] over
30 windows of 100 calls, first of the wrapper alone (``wrapper``) and
then through ``cached_decode_attention``'s dispatch (``dispatch``); the
host's cores are shared, so the least reads the code's own cost best.
Tables, caches and inputs come from fixed seeds.  The first line is the
card's name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HQ, HKV, D = 32, 8, 128
MAIN = [0, 4095, 17, 1000, 2047, 3000, 511, 128]
L, GRANULE = 4096, 128
# paged rows: (block_len, max_blocks, pos, shared first blocks)
PAGED = {
    "main": (128, 32, MAIN, ((1, 4, 16), (5, 3, 8))),
    "bl8": (8, 512, [0, 7, 8, 255, 256, 257, 4095], ((5, 6, 32),)),
    "all4095": (128, 32, [4095] * 8, ((0, 1, 16), (2, 3, 8))),
}
# contiguous rows: (pos, through the identity table)
CONTIGUOUS = {
    "contig main": (MAIN, False),
    "contig all4095": ([4095] * 8, False),
    "identity main": (MAIN, True),
}


def paged_layout(pos_list, bl, mb, share, seed):
    """chip_smoke.py's paged_layout at s = 1: shuffled physical blocks,
    rows sharing their first blocks, null-filled dead tails.  Returns
    (int32 tables (B, mb), pool size in blocks)."""
    import numpy as np
    need = [min(mb, -(-(p + 1) // bl)) for p in pos_list]
    rng = np.random.RandomState(seed)
    n_blocks = sum(need) + 9
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((len(pos_list), mb), np.int32)
    for r, n in enumerate(need):
        for j in range(n):
            tables[r, j] = free.pop()
    for r0, r1, n in share:
        m = min(n, need[r0], need[r1])
        tables[r1, :m] = tables[r0, :m]
    return tables, n_blocks


def measure(checkout: str) -> dict:
    """The JSON line of one checkout (run in a process of its own)."""
    sys.path.insert(0, checkout)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import (cached_decode_attention,
                                      cached_decode_attention_reference)
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def device_us(fns, n=200):
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

    def host_us(fns, windows=30, n=100):
        per = []
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                fns[i % len(fns)]()
            per.append((time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
        return [round(statistics.median(per), 3), round(min(per), 3)]

    def input_sets(b, shape, n_scales, int8):
        """Input copies (q, k, v[, k_scale, v_scale]) enough to cycle past
        L2; ``n_scales`` scale rows."""
        nbytes = 2 * math.prod(shape) * (1 if int8 else 2)
        sets = []
        for _ in range(int(min(8, max(1, math.ceil(150e6 / nbytes))))):
            q = torch.randn((b, 1, HQ, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            if int8:
                kv = [torch.randint(-127, 128, shape, generator=gen,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2)]
                sc = [0.002 + 0.02 * torch.rand(n_scales, HKV, generator=gen,
                                                device=dev)
                      for _ in range(2)]
                sets.append((q, *kv, *sc))
            else:
                sets.append((q, *[torch.randn(shape, generator=gen,
                                              device=dev,
                                              dtype=torch.bfloat16)
                                  for _ in range(2)]))
        return sets

    def paged_fns(pos, tables, int8):
        """(wrapper, dispatch) of one call over input set t."""
        if int8:
            def wrap(t):
                return da.decode_attention_paged_int8_cuda(
                    t[0], t[1], t[2], pos, tables, t[3], t[4])

            def disp(t, fn=cached_decode_attention):
                return fn(t[0], t[1], t[2], pos, block_tables=tables,
                          k_scale=t[3], v_scale=t[4])
        else:
            def wrap(t):
                return da.decode_attention_paged_cuda(t[0], t[1], t[2], pos,
                                                      tables)

            def disp(t, fn=cached_decode_attention):
                return fn(t[0], t[1], t[2], pos, block_tables=tables)
        return wrap, disp

    def contiguous_fns(pos, int8):
        b = pos.shape[0]
        if int8:
            def wrap(t):
                return da.decode_attention_int8_cuda(
                    t[0], t[1], t[2], pos, t[3].view(b, -1, HKV),
                    t[4].view(b, -1, HKV))

            def disp(t, fn=cached_decode_attention):
                return fn(t[0], t[1], t[2], pos,
                          k_scale=t[3].view(b, -1, HKV),
                          v_scale=t[4].view(b, -1, HKV))
        else:
            def wrap(t):
                return da.decode_attention_cuda(t[0], t[1], t[2], pos)

            def disp(t, fn=cached_decode_attention):
                return fn(t[0], t[1], t[2], pos)
        return wrap, disp

    row = {"checkout": checkout}
    for build in ("bf16", "int8"):
        int8 = build == "int8"
        cases = []
        for name, (bl, mb, pos_list, share) in PAGED.items():
            tables, n_blocks = paged_layout(pos_list, bl, mb, share,
                                            seed=len(pos_list))
            tables = torch.from_numpy(tables).to(dev)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            cases.append((name, lambda pos=pos, tables=tables, n=n_blocks,
                          bl=bl: (input_sets(len(pos), (n, bl, HKV, D), n,
                                             int8),
                                  *paged_fns(pos, tables, int8))))
        for name, (pos_list, identity) in CONTIGUOUS.items():
            b = len(pos_list)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            n_gran = L // GRANULE
            if identity:
                tables = (torch.arange(b, dtype=torch.int32, device=dev)[
                    :, None] * n_gran + torch.arange(
                        n_gran, dtype=torch.int32, device=dev)[None])
                cases.append((name, lambda pos=pos, tables=tables, b=b,
                              n=n_gran: (
                                  input_sets(b, (b * n, GRANULE, HKV, D),
                                             b * n, int8),
                                  *paged_fns(pos, tables, int8))))
            else:
                cases.append((name, lambda pos=pos, b=b, n=n_gran: (
                    input_sets(b, (b, L, HKV, D), b * n, int8),
                    *contiguous_fns(pos, int8))))
        for name, make in cases:
            sets, wrap, disp = make()
            want = disp(sets[0], cached_decode_attention_reference)
            err = (wrap(sets[0]).float() - want.float()).abs().max().item()
            wfns = [lambda t=t: wrap(t) for t in sets]
            dfns = [lambda t=t: disp(t) for t in sets]
            row[f"{build} {name}"] = {
                "max_err": round(err, 6), "device_us": device_us(wfns),
                "host_us": {"wrapper": host_us(wfns),
                            "dispatch": host_us(dfns)}}
            del sets, wfns, dfns
    return row


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--measure"]:
        print(json.dumps(measure(args[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for checkout in args or [str(ROOT)]:
        if not (Path(checkout) / "paddle_tpu_torch").is_dir():
            print(f"chip_decode_attention: no paddle_tpu_torch/ in "
                  f"{checkout}", file=sys.stderr)
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
