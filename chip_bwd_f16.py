#!/usr/bin/env python3
"""The float16 flash backward (K5 / K6) beside its bf16 twin on one card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit::

    python3 chip_bwd_f16.py

Builds the backward's bf16 / float32 library and its float16 variant
(``flash_attention_bwd_f16``: the same bodies compiled with ``-DPTT_F16``)
in this process and prints, one JSON line each:

* ``ptxas``: registers and spill bytes of every Hopper K5 / K6 instance
  of both libraries, and any ``wgmma`` serialisation ptxas reported;
* ``case``: the float16 K5 / K6 against ``flash_attention_bwd_reference``
  at D 64, 72, 128, 136 and 256 (causal, Sq 77 over Skv 61, packed
  documents, the ring hop, not causal with 4 query heads a KV head, and
  the range case: dO of std 3e2, V of std 1e3, Q and K of std 1e-2, whose
  float32 dS passes float16's 65504): relative L2 per gradient, the
  largest error over the largest output, finiteness, the same bits twice,
  the largest |dS|;
* ``timing``: K5 and K6 at B 4 x 2048 causal, 32 / 32 heads at D 128 and
  8 / 8 at D 256, by CUDA events, bf16 and float16 in turns (bf16,
  float16, bf16, float16), so the two dtypes are compared within one call.

The last line says whether every case held (relative L2 <= 2e-3, finite,
the same bits twice) and nothing spilled or was serialised.  Exits
non-zero without a card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REL_TOL = 2e-3          # chip_smoke.py's BWD_REL_TOL_F16


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bwd_f16: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv_cuda,
                                      flash_attention_bwd_dq_cuda,
                                      flash_attention_bwd_reference,
                                      flash_attention_fwd_cuda)
    from paddle_tpu_torch.ops.attention import _keep_mask, _repeat_kv
    from paddle_tpu_torch.ops.cuda import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = ("flash_attention_bwd", "flash_attention_bwd_f16")
    _build.build(libs + ("flash_attention_fwd", "flash_attention_fwd_f16"))
    ok = True
    for lib in libs:
        log = _build.build_log.get(lib, "")
        fns, fn, spill = {}, None, 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), 0
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                name = re.search(r"(bwd_\w+?_kernel)I(Lb[01])", fn)
                if name and "wgmma" in name.group(1):
                    fns[f"{name.group(1)}<{name.group(2)[-1]}>"] = {
                        "registers": int(m.group(1)), "spill_stores": spill}
                fn = None
        serialized = [ln.strip() for ln in log.splitlines()
                      if "wgmma" in ln and "serializ" in ln]
        ok = ok and not serialized and all(
            r["spill_stores"] == 0 for r in fns.values())
        print(json.dumps({"ptxas": lib, "functions": fns,
                          "serialized": serialized}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dt=torch.float16, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)

    def segments(b, s, docs):
        cuts = torch.randint(1, s, (b, docs - 1), generator=gen,
                             device=dev)
        pos = torch.arange(s, device=dev)
        return (pos[None, :, None] >= cuts[:, None, :]).sum(-1).int()

    def rel(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    def case(name, b, sq, skv, hq, hkv, d, causal, seg=None, kv_seg=None,
             qk=1.0, vs=1.0, dos=1.0):
        q, k = randn(b, sq, hq, d, scale=qk), randn(b, skv, hkv, d, scale=qk)
        v, do = randn(b, skv, hkv, d, scale=vs), randn(b, sq, hq, d,
                                                       scale=dos)
        kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
        out, lse = flash_attention_fwd_cuda(q, k, v, **kw)
        delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
                 .contiguous())
        got = (flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw),
               *flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))
        again = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
        g = hq // hkv
        qf = q.float().transpose(1, 2)
        kf, vf = (_repeat_kv(t, g).float().transpose(1, 2) for t in (k, v))
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * d ** -0.5
                      - lse[..., None])
        keep = _keep_mask(sq, skv, causal, seg, kv_seg, dev)
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", do.float().transpose(1, 2), vf)
        ds = float((p * (dp - delta[..., None]) * d ** -0.5).abs().max())
        torch.cuda.synchronize()
        res = {"case": name, "head_dim": d,
               "rel_l2": [rel(a, w) for a, w in zip(got, want)],
               "err_of_largest": [float((a.float() - w.float()).abs().max()
                                        / w.float().abs().max()
                                        .clamp_min(1e-30))
                                  for a, w in zip(got, want)],
               "finite": all(bool(torch.isfinite(a).all()) for a in got),
               "same_bits": bool(torch.equal(got[0], again)),
               "max_abs_dS": ds}
        print(json.dumps(res), flush=True)
        return (max(res["rel_l2"]) <= REL_TOL and res["finite"]
                and res["same_bits"])

    for d in (64, 72, 128, 136, 256):
        ok = case("causal", 2, 512, 512, 8, 8, d, True) and ok
        ok = case("dead rows", 2, 77, 61, 8, 8, d, True) and ok
        ok = case("packed", 2, 512, 512, 8, 8, d, True,
                  seg=segments(2, 512, 4)) and ok
        kv = segments(2, 512, 4)
        ok = case("ring hop", 2, 256, 512, 8, 8, d, True,
                  seg=segments(2, 256, 3) + kv.amax(1, keepdim=True) - 1,
                  kv_seg=kv) and ok
        ok = case("not causal, GQA", 2, 512, 512, 8, 2, d, False) and ok
        ok = case("range", 2, 512, 512, 8, 8, d, True, qk=1e-2, vs=1e3,
                  dos=3e2) and ok

    def time_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for dt in (torch.bfloat16, torch.float16) * 2:
        for d, h in ((128, 32), (256, 8)):
            q, k, v, do = (randn(4, 2048, h, d, dt=dt) for _ in range(4))
            out, lse = flash_attention_fwd_cuda(q, k, v, causal=True)
            delta = ((do.float() * out.float()).sum(-1).transpose(1, 2)
                     .contiguous())
            print(json.dumps({
                "timing": str(dt)[6:], "shape": f"B=4 S=2048 Hq=Hkv={h} "
                f"D={d} causal", "card": card,
                "dq_ms": time_ms(lambda: flash_attention_bwd_dq_cuda(
                    q, k, v, do, lse, delta, causal=True)),
                "dkv_ms": time_ms(lambda: flash_attention_bwd_dkv_cuda(
                    q, k, v, do, lse, delta, causal=True))}), flush=True)
            del q, k, v, do, out, lse, delta
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
