"""A numpy model of the float32 flash backward's kernels K5 (dq) and K6
(dk, dv) in ``paddle_tpu_torch/csrc/flash_attention_bwd.cu``
(``tc_body``, :func:`backward`) and of the float32 forward K2, K2-paged
and K2-paged-int8 in ``csrc/flash_attention_fwd.cu``
(``flash_fwd_tf32_kernel``, :func:`forward`): three TF32 passes on
``mma.sync`` m16n8k8 (``csrc/mma_tf32.cuh``), the CTAs' walks over the
tiles, the tile sums, the online softmax and the segment-range skip.

The model restates the kernels' arithmetic, not the card's adder: a TF32
operand is float32 split by :func:`split`, and one ``mma`` adds its
8 products to the float32 accumulator exactly and rounds once (the tensor
cores' own rounding inside a product is the card's to show,
``chip_f32_bwd_accuracy.py``).
"""

from __future__ import annotations

import numpy as np

F32, F64 = np.float32, np.float64

NS = 32          # streamed rows a tile (csrc kTcNS): K5 keys, K6 queries
SUM = 64         # streamed rows a tile sum (kTcSum)
CHUNK = 4        # k steps of 8 columns an S / dP partial sum (kTcChunk)
RANGE = 64       # tokens a segment range covers (kIdRange, RANGE_TILE)
NARROW = 128     # up to this D a CTA owns K5 128 / K6 64 rows, above 32


def rows_a_cta(d: int, dkv: bool) -> int:
    """BR: the rows a CTA owns (``launch_bwd_tf32``)."""
    return (64 if dkv else 128) if d <= NARROW else 32


# ---- TF32 ------------------------------------------------------------------

def tf32_rna(x) -> np.ndarray:
    """``split_tf32``'s hi on float32 bits: (bits + 0x1000) & ~0x1fff, to
    nearest with ties away from zero and the low 13 bits zero -- the bits
    ``cvt.rna.tf32.f32`` gives for every non-NaN x (a carry past the
    largest finite value gives inf); a NaN's may not be NaN."""
    u = np.asarray(x, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def tf32_cut(x) -> np.ndarray:
    """x with its low 13 bits cleared (toward zero; NaN stays NaN)."""
    u = np.asarray(x, F32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    """``split_tf32``: (hi, lo) TF32 values, hi = x rounded, lo = x - hi
    cut: hi + lo within 2^-21 |x| of x."""
    x = np.asarray(x, F32)
    with np.errstate(invalid="ignore", over="ignore"):
        hi = tf32_rna(x)
        lo = tf32_cut((x - hi).astype(F32))
    return hi, lo


def mma(acc, a, b):
    """One ``mma`` over k: acc + a @ b, the products summed exactly (TF32
    operands: float64 holds them) and rounded once to float32."""
    return (acc.astype(F64) + a.astype(F64) @ b.astype(F64)).astype(F32)


def product(acc, a, b, passes: int = 3):
    """acc += a @ b over one k step in TF32 passes: 3 is ``mma_3xtf32``
    (lo hi, hi lo, then hi hi), 1 a single TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return mma(acc, ah, bh)
    acc = mma(acc, al, bh)
    acc = mma(acc, ah, bl)
    return mma(acc, ah, bh)


# ---- m16n8k8 fragments (PTX ISA, .tf32), lane = 4 g + t --------------------

def a_map(lane: int, reg: int):
    """(row, k) of A register ``reg`` of ``lane``."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg & 1), t + 4 * (reg >> 1)


def b_map(lane: int, reg: int):
    """(k, col) of B register ``reg``."""
    g, t = divmod(lane, 4)
    return t + 4 * reg, g


def c_map(lane: int, reg: int):
    """(row, col) of C register ``reg``."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg >> 1), 2 * t + (reg & 1)


# the A register each C register becomes (a[0] = c[0], a[1] = c[2], a[2] =
# c[1], a[3] = c[3]) and the C column that is B's k row t (0..3) / t + 4
C_AS_A = (0, 2, 1, 3)


def perm_k(k: int) -> int:
    """The C-tile column under the permuted k order: k t <- 2t, k t + 4 <-
    2t + 1."""
    return 2 * k if k < 4 else 2 * (k - 4) + 1


# ---- the walk ----------------------------------------------------------------

def _range(rng, b, r0, r1):
    """[min, max] id of rows r0..r1 from their 64-token ranges."""
    lo = min(int(rng[b, t, 0]) for t in range(r0 // RANGE, r1 // RANGE + 1))
    hi = max(int(rng[b, t, 1]) for t in range(r0 // RANGE, r1 // RANGE + 1))
    return lo, hi


def tile_ranges(ids) -> np.ndarray:
    """(B, ceil(S / 64), 2) [min, max] of every 64 tokens of ``ids``."""
    b, s = ids.shape
    n = -(-s // RANGE)
    out = np.zeros((b, n, 2), np.int64)
    for t in range(n):
        blk = ids[:, t * RANGE:(t + 1) * RANGE]
        out[:, t, 0], out[:, t, 1] = blk.min(1), blk.max(1)
    return out


def walk(dkv: bool, b: int, r0: int, br: int, sq: int, skv: int, g: int,
         causal: bool, q_rng=None, kv_rng=None):
    """The streamed tiles a CTA visits, in order: (q head index within the
    group (K6; 0 for K5), first streamed row).  K5's rows are queries
    [r0, r0 + br), its tiles 32 keys up to the last one a row sees; K6's
    rows are keys, its tiles 32 queries of each of the group's g q heads
    from the first tile that sees a key of the CTA.  With ids a tile whose
    id range misses the CTA's is skipped."""
    off = skv - sq
    sr, ss = (skv, sq) if dkv else (sq, skv)
    r_last = min(sr, r0 + br) - 1
    if dkv:
        qt_lo = (max(0, r0 - off) if causal else 0) // NS
        tiles = [(gi, qt * NS) for gi in range(g)
                 for qt in range(qt_lo, -(-sq // NS))]
    else:
        hi = min(skv, r_last + off + 1) if causal else skv
        tiles = [(0, u * NS) for u in range(-(-hi // NS))] if hi > 0 else []
    if q_rng is None:
        return tiles
    lo, hi = _range(kv_rng if dkv else q_rng, b, r0, r_last)
    srng = q_rng if dkv else kv_rng
    out = []
    for gi, s0 in tiles:
        slo, shi = _range(srng, b, s0, min(ss, s0 + NS) - 1)
        if shi >= lo and slo <= hi:
            out.append((gi, s0))
    return out


# ---- the kernels --------------------------------------------------------------

def _scores(x, y, passes):
    """S = x y^T over D in partials of CHUNK k steps, as phase A sums."""
    d = x.shape[1]
    s = np.zeros((x.shape[0], y.shape[0]), F32)
    for k0 in range(0, d // 8, CHUNK):
        ts = np.zeros_like(s)
        for kk in range(k0, min(d // 8, k0 + CHUNK)):
            c = slice(8 * kk, 8 * kk + 8)
            ts = product(ts, x[:, c], y[:, c].T, passes)
        s = (s + ts).astype(F32)
    return s


def backward(q, k, v, do, lse, delta, causal=False, scale=None,
             seg_q=None, seg_kv=None, passes=3, walks=None):
    """(dq, dk, dv) as K5 and K6 compute them: q, do (B, Sq, Hq, D), k, v
    (B, Skv, Hkv, D), lse, delta (B, Hq, Sq), float32 numpy arrays; ids
    (B, S) int or None.  ``walks``, a list, collects each CTA's walk as
    (kernel, b, head, r0, tiles)."""
    b_, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    off = skv - sq
    scale = F32(d ** -0.5 if scale is None else scale)
    seg = seg_q is not None
    q_rng = tile_ranges(seg_q) if seg else None
    kv_rng = tile_ranges(seg_kv) if seg else None
    dq = np.zeros_like(q)
    dk, dv = np.zeros_like(k), np.zeros_like(v)

    def padded(a, s0, n):
        out = np.zeros((n, d), F32)
        part = a[s0:s0 + n]
        out[:len(part)] = part
        return out

    def p_ds(s, dp, qi, kj, lsev, dlv, idq, idk):
        vis = (qi < sq) & (kj < skv)
        if causal:
            vis &= kj <= qi + off
        if seg:
            vis &= idq == idk
        with np.errstate(over="ignore", invalid="ignore"):
            p = np.exp((s * scale).astype(F32) - lsev).astype(F32)
            ds = ((p * (dp - dlv).astype(F32)).astype(F32) * scale
                  ).astype(F32)
        return np.where(vis, p, F32(0)), np.where(vis, ds, F32(0))

    for dkv in (False, True):
        br = rows_a_cta(d, dkv)
        nrows = skv if dkv else sq
        for bi in range(b_):
            for hr in range(hkv if dkv else hq):
                for r0 in range(0, nrows, br):
                    tiles = walk(dkv, bi, r0, br, sq, skv, g, causal, q_rng,
                                 kv_rng)
                    if walks is not None:
                        walks.append(("dkv" if dkv else "dq", bi, hr, r0,
                                      tiles))
                    rows = np.arange(r0, r0 + br)
                    if dkv:
                        x1 = padded(k[bi, :, hr], r0, br)
                        x2 = padded(v[bi, :, hr], r0, br)
                        acc = [np.zeros((br, d), F32) for _ in range(2)]
                    else:
                        hk = hr // g
                        x1 = padded(q[bi, :, hr], r0, br)
                        x2 = padded(do[bi, :, hr], r0, br)
                        acc = [np.zeros((br, d), F32)]
                    tsum = [np.zeros_like(a) for a in acc]
                    for n, (gi, s0) in enumerate(tiles):
                        cols = np.arange(s0, s0 + NS)
                        if dkv:
                            h = hr * g + gi
                            y1 = padded(q[bi, :, h], s0, NS)
                            y2 = padded(do[bi, :, h], s0, NS)
                            qi, kj = cols[None, :], rows[:, None]
                            cq = np.minimum(cols, sq - 1)
                            lsev = np.where(cols < sq, lse[bi, h, cq], 0)
                            dlv = np.where(cols < sq, delta[bi, h, cq], 0)
                            lsev, dlv = lsev[None].astype(F32), \
                                dlv[None].astype(F32)
                        else:
                            y1 = padded(k[bi, :, hk], s0, NS)
                            y2 = padded(v[bi, :, hk], s0, NS)
                            qi, kj = rows[:, None], cols[None, :]
                            rq = np.minimum(rows, sq - 1)
                            lsev = np.where(rows < sq, lse[bi, hr, rq], 0)
                            dlv = np.where(rows < sq, delta[bi, hr, rq], 0)
                            lsev, dlv = lsev[:, None].astype(F32), \
                                dlv[:, None].astype(F32)
                        idq = idk = None
                        if seg:
                            idq = seg_q[bi, np.minimum(qi, sq - 1)]
                            idk = seg_kv[bi, np.minimum(kj, skv - 1)]
                        s = _scores(x1, y1, passes)
                        dp = _scores(x2, y2, passes)
                        p, ds = p_ds(s, dp, qi, kj, lsev, dlv, idq, idk)
                        # phase B: one product a k step of 8 streamed rows
                        pairs = ([(p, y2), (ds, y1)] if dkv else [(ds, y1)])
                        for i, (a_, y) in enumerate(pairs):
                            for kk in range(NS // 8):
                                c = slice(8 * kk, 8 * kk + 8)
                                tsum[i] = product(tsum[i], a_[:, c], y[c],
                                                  passes)
                        nxt = tiles[n + 1] if n + 1 < len(tiles) else None
                        if nxt is None or (nxt[0], nxt[1] // SUM) != (
                                gi, s0 // SUM):
                            for i in range(len(acc)):
                                acc[i] = (acc[i] + tsum[i]).astype(F32)
                                tsum[i][:] = 0
                    n_out = min(br, nrows - r0)
                    if dkv:
                        dv[bi, r0:r0 + n_out, hr] = acc[0][:n_out]
                        dk[bi, r0:r0 + n_out, hr] = acc[1][:n_out]
                    else:
                        dq[bi, r0:r0 + n_out, hr] = acc[0][:n_out]
    return dq, dk, dv


# ---- the forward: K2, K2-segmented, K2-paged(-int8) (csrc/flash_attention_fwd.cu
# flash_fwd_tf32_kernel) --------------------------------------------------------

LOG2E = F32(1.4426950408889634)   # kLog2e: the scale is taken to exp2 units
LN2 = F32(0.6931471805599453)     # kLn2: lse back to natural-log units


def fwd_tiles(d: int):
    """(queries a CTA, keys a tile, warps a row group) of ``launch_tf32``:
    128 / 64 / 1 up to D 128, 64 / 32 / 2 above (the two warps of a row
    group each form S over half of the tile's keys, exchange the row
    maxima and P through shared memory and own half of O's columns)."""
    return (128, 64, 1) if d <= NARROW else (64, 32, 2)


def fwd_cta_order(n_qt: int, hq: int, b: int):
    """(q tile, q head, batch row) of each CTA of the 1-D grid in launch
    order: the heaviest (last) q tiles of every (row, head) first."""
    return [(n_qt - 1 - x // (hq * b), x % hq, (x // hq) % b)
            for x in range(n_qt * hq * b)]


def fwd_walk(q0, bq, nk, sq, skv, off, kv_len, causal, b=0, q_rng=None,
             kv_rng=None):
    """The key tiles the CTA of queries [q0, q0 + bq) visits, in order, as
    (u, flags): tile u holds keys [u nk, u nk + nk); ``flags[rg]`` is None
    where the 16 rows of row group rg see no key of the tile (the warp skips
    it), else whether the tile needs the element mask for them.  Keys j <
    kv_len exist, query i sees j <= i + off when causal; with ids (their
    64-token ranges) a tile whose range misses the CTA's is not loaded."""
    q_last = min(sq, q0 + bq) - 1
    kv_hi = min(kv_len, q_last + off + 1) if causal else kv_len
    n_kt = -(-kv_hi // nk) if kv_hi > 0 else 0
    seg = q_rng is not None
    cr = _range(q_rng, b, q0, q_last) if seg else None
    out = []
    for u in range(n_kt):
        k0 = u * nk
        if seg:
            kr = _range(kv_rng, b, k0, min(skv, k0 + nk) - 1)
            if kr[1] < cr[0] or kr[0] > cr[1]:
                continue
        flags = []
        for r_lo in range(q0, q0 + bq, 16):
            r_top = min(sq - 1, r_lo + 15)
            any_ = r_lo < sq and (not causal or k0 <= r_top + off)
            masked = k0 + nk > kv_len or (causal and k0 + nk - 1 > r_lo + off)
            if seg and r_lo < sq:
                wr = _range(q_rng, b, r_lo, r_top)
                any_ = any_ and kr[1] >= wr[0] and kr[0] <= wr[1]
                masked = masked or not wr[0] == wr[1] == kr[0] == kr[1]
            flags.append(masked if any_ else None)
        out.append((u, flags))
    return out


def _lane_sums(p, nt, wpr):
    """Each lane t's partial row sum of a tile's probabilities, as the
    kernel adds them: columns 8j + 2t, 8j + 2t + 1 over the n-tiles j of
    the lane's warp (all nt, or with two warps a row group the half each
    forms), in float32.  p: (rows, 8 nt) -> (rows, wpr, 4)."""
    ps = np.zeros((p.shape[0], wpr, 4), F32)
    q4 = p.reshape(p.shape[0], nt, 4, 2)
    ns = nt // wpr
    for w in range(wpr):
        for j in range(w * ns, (w + 1) * ns):
            for x in range(2):
                ps[:, w] = (ps[:, w] + q4[:, j, :, x]).astype(F32)
    return ps


def forward(q, k, v, causal=False, scale=None, seg_q=None, seg_kv=None,
            pos=None, table=None, k_scale=None, v_scale=None, passes=3,
            walks=None):
    """(out, lse) as the float32 K2 body computes them.  Contiguous: q (B,
    Sq, Hq, D), k, v (B, Skv, Hkv, D) float32 numpy arrays, ids (B, S) int
    or None.  Paged (``table`` (B, max_blocks) given): k, v one layer's
    (num_blocks, block_len, Hkv, D) pool -- float32, or int8 with float32
    (num_blocks, Hkv) ``k_scale`` / ``v_scale`` -- ``pos`` (B,) offsets,
    always causal; lse is None.  ``walks``, a list, collects each CTA's
    (b, h, q0, walk) in launch order (:func:`fwd_walk`).

    Per CTA and key tile: S = Q K^T over D in partials of CHUNK k steps,
    times scale log2(e) (int8: and each key's K scale; the int8 values are
    exact in TF32, so :func:`product`'s lo terms of them are 0), masked,
    the online softmax in exp2 units with each lane's partial row sums
    (two warps a row group: each over its half of the keys, the row maxima
    of both halves combined, the warps' sums added at the end),
    then O += P V one k step of 8 keys at a time (int8: P times each key's
    V scale).  A row group the walk skips keeps its state; computing every
    row with the exact mask is the same arithmetic (a masked tile adds
    zero products exactly), so the model applies each tile's result to the
    rows of the row groups that visit it."""
    b_, sq, hq, d = q.shape
    paged = table is not None
    hkv = k.shape[2]
    g = hq // hkv
    bq, nk, wpr = fwd_tiles(d)
    nt = nk // 8
    sc = F32(d ** -0.5 if scale is None else scale)
    c = F32(sc * LOG2E)
    seg = seg_q is not None
    q_rng = tile_ranges(seg_q) if seg else None
    kv_rng = tile_ranges(seg_kv) if seg else None
    skv = k.shape[1]
    out = np.zeros_like(q)
    lse = None if paged else np.full((b_, hq, sq), F32(-1e30), F32)
    n_qt = -(-sq // bq)
    for qt, h, bi in fwd_cta_order(n_qt, hq, b_):
        hk = h // g
        q0 = qt * bq
        if paged:
            bl, mb = k.shape[1], table.shape[1]
            off = int(pos[bi])
            kv_len = min(off + sq, mb * bl)
            keys = np.arange(mb * bl)
            blk = table[bi, keys // bl]
            kd = k[blk, keys % bl, hk].astype(F32)
            vd = v[blk, keys % bl, hk].astype(F32)
            ksd = (k_scale[blk, hk] if k_scale is not None
                   else np.ones(mb * bl, F32))
            vsd = (v_scale[blk, hk] if v_scale is not None
                   else np.ones(mb * bl, F32))
        else:
            off, kv_len = skv - sq, skv
            kd, vd = k[bi, :, hk], v[bi, :, hk]
            ksd = vsd = np.ones(skv, F32)
        walk = fwd_walk(q0, bq, nk, sq, skv, off, kv_len, causal, bi, q_rng,
                        kv_rng)
        if walks is not None:
            walks.append((bi, h, q0, walk))
        rows = np.arange(q0, q0 + bq)
        qrows = np.zeros((bq, d), F32)
        qrows[:min(bq, sq - q0)] = q[bi, q0:q0 + bq, h]
        idq = (seg_q[bi, np.minimum(rows, sq - 1)] if seg else None)
        m = np.full(bq, -np.inf, F32)
        lpart = np.zeros((bq, wpr, 4), F32)
        o = np.zeros((bq, d), F32)
        for u, flags in walk:
            k0 = u * nk
            cols = np.arange(k0, k0 + nk)
            live = cols < kv_len
            kt = np.zeros((nk, d), F32)
            vt = np.zeros((nk, d), F32)
            kt[live] = kd[cols[live]]
            vt[live] = vd[cols[live]]
            kst = np.where(live, ksd[np.minimum(cols, len(ksd) - 1)], 0)
            vst = np.where(live, vsd[np.minimum(cols, len(vsd) - 1)], 0)
            s = np.zeros((bq, nk), F32)
            for k0c in range(0, d // 8, CHUNK):
                ts = np.zeros_like(s)
                for kk in range(k0c, min(d // 8, k0c + CHUNK)):
                    cc = slice(8 * kk, 8 * kk + 8)
                    ts = product(ts, qrows[:, cc], kt[:, cc].T, passes)
                s = (s + ts).astype(F32)
            s = (s * (c * kst.astype(F32)).astype(F32)[None]).astype(F32)
            vis = live[None] & np.ones((bq, 1), bool)
            if causal:
                vis &= cols[None] <= rows[:, None] + off
            if seg:
                vis &= idq[:, None] == seg_kv[bi, np.minimum(cols,
                                                             skv - 1)][None]
            s = np.where(vis, s, F32(-np.inf))
            m_new = np.maximum(m, s.max(1))
            mu = np.where(m_new == -np.inf, F32(0), m_new).astype(F32)
            with np.errstate(invalid="ignore"):
                alpha = np.exp2(m - mu).astype(F32)
                p = np.exp2(s - mu[:, None]).astype(F32)
            lp = (lpart * alpha[:, None, None]
                  + _lane_sums(p, nt, wpr)).astype(F32)
            pv = (p * vst.astype(F32)[None]).astype(F32)
            on = (o * alpha[:, None]).astype(F32)
            for j in range(nt):
                cc = slice(8 * j, 8 * j + 8)
                on = product(on, pv[:, cc], vt[cc], passes)
            act = np.repeat([f is not None for f in flags], 16)
            m = np.where(act, m_new, m)
            lpart = np.where(act[:, None, None], lp, lpart)
            o = np.where(act[:, None], on, o)
        # each warp's quad, then the two warps of a row group
        quad = ((lpart[..., 0] + lpart[..., 1]).astype(F32)
                + (lpart[..., 2] + lpart[..., 3]).astype(F32)).astype(F32)
        lsum = quad[:, 0]
        for w in range(1, wpr):
            lsum = (lsum + quad[:, w]).astype(F32)
        with np.errstate(divide="ignore"):
            inv = np.where(lsum > 0, F32(1) / lsum, F32(0)).astype(F32)
            lrow = np.where(lsum > 0, (m * LN2).astype(F32)
                            + np.log(lsum).astype(F32), F32(-1e30))
        n = min(bq, sq - q0)
        out[bi, q0:q0 + n, h] = (o * inv[:, None]).astype(F32)[:n]
        if lse is not None:
            lse[bi, h, q0:q0 + n] = lrow.astype(F32)[:n]
    return out, lse
