"""The port's weight-only quantization (``paddle_tpu_torch/nn/quant.py``,
``models/quantized.py``, K4's plain version) against the JAX package's, on
the CPU.

* ``weight_quantize`` / ``weight_dequantize`` / the int4 unpack are
  bit-exact with JAX (both round half to even), a zero column included.
* ``weight_only_linear``'s plain route and K4's plain version
  ``int8_matmul_reference`` match ``int8_matmul_pallas`` in interpret mode
  and the reference's XLA composition at float32 within 1e-5 (the
  libraries sum in other orders).
* The routing rule: CPU tensors take the plain route; on the card rows <=
  256 with K a multiple of 8 and N of 16 (bfloat16 x) or 8 (float32 x)
  take K4, anything else the dequantize-then-matmul composition; K4's K
  split per build.
* ``QuantizedForDecode``: the same quantized names and ``hbm_bytes`` as the
  JAX wrapper, weights bridged from its packed state equal to the port's
  own quantization, and a decode session within 1e-5 of the JAX model
  run on the dequantized weights (what its engine binds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.generation import init_kv_cache as jax_init_cache
from paddle_tpu.models.quantized import (
    quantize_for_decode as jax_quantize_for_decode)
from paddle_tpu.nn import quant as jq
from paddle_tpu.nn.layer import bind_params
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul_pallas

from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     init_kv_cache,
                                     load_jax_quantized_state_dict,
                                     load_jax_state_dict, quantize_for_decode)
from paddle_tpu_torch.nn import quant
from paddle_tpu_torch.ops import _dispatch, int8_matmul_cuda
from paddle_tpu_torch.ops.cuda.int8_matmul import (int8_matmul_reference,
                                                   split_k)

TOL = dict(rtol=1e-5, atol=1e-5)
MIN_ELEMS = 2048      # every tiny projection, not the 128 x 8 RoPE tables


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _weight(k, n, seed):
    w = _rand((k, n), seed)
    w[:, 3] = 0.0                      # a zero column: scale 0, zeros
    w[:, 5] *= 40.0                    # a column of large values
    return w


# ---- weight_quantize / dequantize -----------------------------------------------

@pytest.mark.parametrize("k,n", [(64, 32), (33, 16)])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_quantize_bit_exact(algo, k, n):
    w = _weight(k, n, k)
    q, s = quant.weight_quantize(torch.from_numpy(w), algo=algo)
    jqw, js = jq.weight_quantize(jnp.asarray(w), algo=algo)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[3] == 0
    deq = quant.weight_dequantize(q, s, algo=algo, out_dtype=torch.float32,
                                  k=k)
    jdeq = jq.weight_dequantize(jqw, js, algo=algo, out_dtype=jnp.float32,
                                k=k)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    assert not deq[:, 3].any()


def test_int4_unpack_matches_reference():
    q = torch.from_numpy(np.random.default_rng(0).integers(
        -128, 128, (9, 6)).astype(np.int8))
    np.testing.assert_array_equal(
        quant._unpack_int4(q, 17).numpy(),
        np.asarray(jq._unpack_int4(jnp.asarray(q.numpy()), 17)))


# ---- weight_only_linear and K4's plain version ------------------------------------

@pytest.mark.parametrize("rows", [1, 8, 20])
def test_weight_only_linear_matches_pallas_and_xla(rows):
    k, n = 256, 384                    # the Pallas kernel needs K, N % 128
    # activations of unit-scale outputs, so that 1e-5 is a few f32 ulps of
    # the 256-term sums (the libraries sum in other orders)
    x = _rand((rows, k), 1) / 16
    w8, s = jq.weight_quantize(jnp.asarray(_weight(k, n, 2)))
    want_pallas = np.asarray(int8_matmul_pallas(jnp.asarray(x), w8, s,
                                                interpret=True))
    want_xla = np.asarray(jq.weight_only_linear(jnp.asarray(x), w8,
                                                weight_scale=s))
    tx, tw, ts = (torch.from_numpy(np.array(a)) for a in (x, w8, s))
    _dispatch.reset_kernel_paths()
    got = quant.weight_only_linear(tx, tw, weight_scale=ts)
    assert dict(_dispatch.kernel_paths) == {("int8_matmul", "plain"): 1}
    ref = int8_matmul_reference(tx, tw, ts)
    for a in (got, ref):
        np.testing.assert_allclose(a.numpy(), want_pallas, **TOL)
        np.testing.assert_allclose(a.numpy(), want_xla, **TOL)
    # a batch of rows and a bias go through the same product
    got3 = quant.weight_only_linear(tx.reshape(1, rows, k), tw,
                                    bias=torch.ones(n), weight_scale=ts)
    np.testing.assert_allclose(got3[0].numpy(), want_xla + 1.0, **TOL)


def test_int8_matmul_path_rule(monkeypatch):
    x = torch.zeros(8, 64)
    assert quant.int8_matmul_path(x, 64, 32) == "plain"
    monkeypatch.setattr(_dispatch, "use_kernel", lambda t: True)
    assert quant.int8_matmul_path(x, 64, 32) == "kernel"
    assert quant.int8_matmul_path(torch.zeros(2, 128, 64), 64, 32) == \
        "kernel"                                   # 256 rows
    assert quant.int8_matmul_path(torch.zeros(257, 64), 64, 32) == "dequant"
    assert quant.int8_matmul_path(torch.zeros(8, 60), 60, 32) == "dequant"
    assert quant.int8_matmul_path(torch.zeros(8, 64), 64, 36) == "dequant"
    # the bf16 build loads weight rows by TMA: N bytes a multiple of 16
    xb = torch.zeros(8, 64, dtype=torch.bfloat16)
    assert quant.int8_matmul_path(xb, 64, 48) == "kernel"
    assert quant.int8_matmul_path(xb, 64, 40) == "dequant"
    assert quant.int8_matmul_path(torch.zeros(8, 64), 64, 40) == "kernel"


def test_split_k_fills_the_card():
    # bf16 build: one 128-column CTA an SM for every row count, so the
    # split depends on N only: as many splits as stay within one wave of
    # 132 CTAs, chunks of at least 256 k and a multiple of 64
    for rows, k, n, want in ((8, 4096, 1024, 16), (8, 4096, 4096, 4),
                             (8, 4096, 14336, 1), (8, 14336, 4096, 4),
                             (8, 4096, 128256, 1), (256, 4096, 4096, 4),
                             (64, 4096, 14336, 1), (8, 64, 32, 1)):
        ksplit, chunk = split_k(rows, k, n)
        assert ksplit == want, (rows, k, n, ksplit)
        assert chunk % 64 == 0 and (ksplit - 1) * chunk < k <= ksplit * chunk
        ctas = -(-n // 128) * ksplit
        assert ctas <= 132 or ksplit == 1
        assert (ksplit + 1) * -(-n // 128) > 132 or k // (ksplit + 1) < 256
    # float32 build: 4 CTAs an SM of 128 columns x 8 or 16 rows
    for rows, k, n in ((8, 4096, 1024), (8, 4096, 4096), (8, 4096, 14336),
                       (8, 14336, 4096), (8, 4096, 128256), (256, 4096, 4096),
                       (8, 64, 32)):
        ksplit, chunk = split_k(rows, k, n, bf16=False)
        assert chunk % 16 == 0 and (ksplit - 1) * chunk < k <= ksplit * chunk
        ctas = -(-n // 128) * -(-rows // (8 if rows <= 8 else 16)) * ksplit
        assert ctas >= 132 or ksplit == max(1, k // 128), (rows, k, n)


def test_int8_matmul_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        int8_matmul_cuda(torch.zeros(8, 64), torch.zeros(64, 32,
                                                         dtype=torch.int8),
                         torch.ones(32))


# ---- QuantizedForDecode -----------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    pt.seed(9)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


def _packed(jwrap):
    return {part: {k: np.asarray(v) for k, v in d.items()}
            for part, d in jwrap.state_dict().items()}


@pytest.mark.parametrize("min_elems", [MIN_ELEMS, 65536])
def test_quantized_names_and_hbm_bytes_match_jax(pair, min_elems):
    jm, tm = pair
    jw = jax_quantize_for_decode(jm, min_elems=min_elems)
    tw = quantize_for_decode(tm, min_elems=min_elems)
    assert tw.quantized_names == jw.quantized_names
    assert tw.hbm_bytes() == tuple(int(v) for v in jw.hbm_bytes())
    if min_elems == MIN_ELEMS:
        assert len(tw.quantized_names) == 7 * 2 + 2   # + embed, lm_head
        assert tw.hbm_bytes()[0] < tw.hbm_bytes()[1]
    else:
        assert tw.quantized_names == []           # the tiny model is small


def test_rope_tables_stay_full_precision(pair):
    """The reference also quantizes 2-D buffers past ``min_elems`` (the
    RoPE tables); the port quantizes parameters only (ROADMAP §C)."""
    jm, tm = pair
    jw = jax_quantize_for_decode(jm, min_elems=512)
    tw = quantize_for_decode(tm, min_elems=512)
    assert (set(jw.quantized_names) - set(tw.quantized_names)
            == {"model.rope_cos", "model.rope_sin"})
    assert torch.equal(tw.unwrapped.model.rope_cos, tm.model.rope_cos)


def test_wrapper_keeps_only_int8_copies(pair):
    _, tm = pair
    tw = quantize_for_decode(tm, min_elems=MIN_ELEMS)
    q = tw.unwrapped.model.layers[0].self_attn.q_proj
    assert isinstance(q, quant.Int8Weight) and q.w8.dtype == torch.int8
    assert not any(n in dict(tw.named_parameters())
                   for n in ("unwrapped." + m for m in tw.quantized_names))
    own = {p.data_ptr() for p in tm.parameters()}
    assert not own & {t.data_ptr() for t in tw.state_dict().values()}
    # the source model is untouched
    assert isinstance(tm.model.layers[0].self_attn.q_proj,
                      torch.nn.Parameter)


def test_bridge_from_jax_packed_state(pair):
    jm, tm = pair
    jw = jax_quantize_for_decode(jm, min_elems=MIN_ELEMS)
    mine = quantize_for_decode(tm, min_elems=MIN_ELEMS)
    bridged = quantize_for_decode(tm, min_elems=MIN_ELEMS)
    with torch.no_grad():
        for t in bridged.unwrapped.state_dict().values():
            t.zero_()
    load_jax_quantized_state_dict(bridged, _packed(jw))
    a, b = mine.unwrapped.state_dict(), bridged.unwrapped.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    packed = mine.state_dict_packed()
    assert sorted(packed["qw"]) == jw.quantized_names


def test_quantized_decode_matches_jax_dequantized(pair):
    """Prefill at pos 0 then two per-row steps: the port wrapper (int8
    weights through weight_only_linear, int8 embedding gather) against
    the JAX model bound to the wrapper's dequantized params, as its
    engine runs it; logits within 1e-5."""
    jm, tm = pair
    jw = jax_quantize_for_decode(jm, min_elems=MIN_ELEMS)
    tw = quantize_for_decode(tm, min_elems=MIN_ELEMS)
    prepared = jw._prepare_params(jw.state_dict())
    rng = np.random.RandomState(3)
    steps = [(rng.randint(0, 256, (2, 9)).astype(np.int32), 0),
             (rng.randint(0, 256, (2, 1)).astype(np.int32),
              np.asarray([9, 9], np.int32)),
             (rng.randint(0, 256, (2, 1)).astype(np.int32),
              np.asarray([10, 10], np.int32))]
    jc = jax_init_cache(jm.config, 2, 32)
    tc = init_kv_cache(tw.config, 2, 32, device="cpu")
    for ids, pos in steps:
        with bind_params(jm, prepared):
            jl, jc = jm.decode_step(jnp.asarray(ids), jc,
                                    pos if isinstance(pos, int)
                                    else jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tw.decode_step(torch.from_numpy(ids), tc,
                                    pos if isinstance(pos, int)
                                    else torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
