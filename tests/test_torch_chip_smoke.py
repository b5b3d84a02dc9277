"""Host-side helpers of ``chip_smoke.py`` (the port's check on the card),
on the CPU: the ptxas-log guard against serialised ``wgmma``, the
visible-pair rule its contract rows hold the kernels to, the serving
phases' checks of the once-built decode step (the graph contract and the
eager twin's token comparison), and the training phases' batch, FLOP
count, gradient gate, card-vs-CPU comparison and K5 / K6 same-bits
recorder."""

import importlib.util
import json
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.ops.attention import _keep_mask
from torch_chip_rehearsal import CARD_ONLY as _CARD_ONLY
from torch_chip_rehearsal import TorchOnCpu as _TorchOnCpu

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

_LOG = """\
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas warning : (C7514) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to non wgmma instructions defining \
accumulator registers of a wgmma between start and end of the pipeline \
stage in the function '_Z3barPf'
ptxas info    : Function properties for _Z3barPf
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '_Z3bazPf'
ptxas info    : Compiling entry function '_Z3bazPf' for 'sm_90a'
ptxas info    : Function properties for _Z3bazPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
"""


def test_serialized_wgmma_names_the_kernel():
    """Both wordings ptxas uses: "in the function" (C7514) and "for the
    function" (C7512, printed before the function's own report)."""
    found = chip_smoke.serialized_wgmma(_LOG)
    assert [f for f, _ in found] == ["_Z3barPf", "_Z3bazPf"]
    assert found[0][1].startswith("due to non wgmma instructions")
    assert found[1][1] == "due to insufficient register resources"
    assert chip_smoke.ptxas_functions(_LOG) == {
        "_Z3fooPf": {"registers": 168, "spill_stores": 0},
        "_Z3barPf": {"registers": 240, "spill_stores": 8},
        "_Z3bazPf": {"registers": 168, "spill_stores": 0}}


def test_clean_log_passes_the_guard():
    clean = "\n".join(line for line in _LOG.splitlines()
                      if "serialized" not in line)
    assert chip_smoke.serialized_wgmma(clean) == []


@pytest.mark.parametrize("sq,skv,causal,cross",
                         [(9, 9, True, False), (5, 13, True, True),
                          (13, 5, True, False), (7, 11, False, True)])
def test_visible_pairs_match_the_plain_rule(sq, skv, causal, cross):
    """chip_smoke's mask (its dead-row checks and bounds) is the plain
    versions' rule."""
    rng = np.random.default_rng(sq * skv)
    ids_q = torch.from_numpy(rng.integers(0, 3, (2, sq)).astype(np.int32))
    ids_k = (torch.from_numpy(rng.integers(0, 3, (2, skv)).astype(np.int32))
             if cross else ids_q[:, :skv])
    if not cross and sq != skv:
        ids_q = ids_k = None
    got = chip_smoke.visible_pairs(torch, sq, skv, causal, ids_q, ids_k)
    want = _keep_mask(sq, skv, causal, ids_q, ids_k, "cpu")
    assert torch.equal(got.expand(2, sq, skv),
                       want.expand(2, 1, sq, skv)[:, 0])
    dead = ~got.any(-1).expand(2, sq)
    out = torch.randn(2, sq, 3, 4)
    out[dead] = 0
    lse = torch.randn(2, 3, sq)
    lse.transpose(1, 2)[dead] = -1e30
    assert chip_smoke.dead_rows_ok(torch, got, 2, out, lse, out)
    if dead.any():
        out[dead] = 1.0
        assert not chip_smoke.dead_rows_ok(torch, got, 2, out=out)


@pytest.mark.parametrize("graphed,m,bad", [
    (True, {"step_traces": 1, "graph_replays": 62, "decode_ticks": 62}, 0),
    (False, {"step_traces": 1, "graph_replays": 0, "decode_ticks": 62}, 0),
    (True, {"step_traces": 2, "graph_replays": 62, "decode_ticks": 62}, 1),
    (True, {"step_traces": 1, "graph_replays": 0, "decode_ticks": 62}, 1),
    (False, {"step_traces": 0, "graph_replays": 3, "decode_ticks": 62}, 2),
    # the chunked engine: two graphs, one replay a decode or mixed tick
    (True, {"step_traces": 1, "decode_step_traces": 1, "graph_replays": 40,
            "decode_ticks": 30, "mixed_ticks": 10}, 0),
    (True, {"step_traces": 1, "decode_step_traces": 1, "graph_replays": 30,
            "decode_ticks": 30, "mixed_ticks": 10}, 1),
    (False, {"step_traces": 1, "decode_step_traces": 2, "graph_replays": 0,
             "decode_ticks": 30, "mixed_ticks": 10}, 1),
    # the wave engines: one prefill-graph replay a wave when graphed
    (True, {"step_traces": 1, "graph_replays": 62, "decode_ticks": 62,
            "prefill_waves": 12, "prefill_graph_replays": 12}, 0),
    (True, {"step_traces": 1, "graph_replays": 62, "decode_ticks": 62,
            "prefill_waves": 12, "prefill_graph_replays": 11}, 1),
    (False, {"step_traces": 1, "graph_replays": 0, "decode_ticks": 62,
             "prefill_waves": 12, "prefill_graph_replays": 0}, 0),
    (False, {"step_traces": 1, "graph_replays": 0, "decode_ticks": 62,
             "prefill_waves": 12, "prefill_graph_replays": 12}, 1)])
def test_graph_contract(graphed, m, bad):
    """One build of each step, and one replay a tick (and a wave)
    exactly when graphed."""
    found = chip_smoke.graph_contract(m, graphed)
    assert len(found) == bad
    with pytest.raises(chip_smoke.CheckFailed) if bad else nullcontext():
        chip_smoke.check_graph({"graphed": graphed, "metrics": m}, "x",
                               graphed=graphed)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check_graph({"graphed": not graphed, "metrics": m}, "x",
                               graphed=graphed)


@pytest.mark.parametrize("keys,traces,ok", [
    ([(8, 1), (2048, 1), (8, 1)], 2, True),
    ([(8, 1), (8, 2)], 2, True),
    ([(8, 1), (8, 1)], 2, False),       # a key built twice
    ([(8, 1), (16, 1)], 1, False)])
def test_prefill_traces_count_distinct_wave_keys(keys, traces, ok):
    m = {"step_traces": 1, "graph_replays": 5, "decode_ticks": 5,
         "prefill_waves": len(keys), "prefill_graph_replays": len(keys),
         "prefill_traces": traces}
    run = {"graphed": True, "metrics": m, "wave_keys": keys}
    with nullcontext() if ok else pytest.raises(chip_smoke.CheckFailed,
                                                match="distinct wave keys"):
        chip_smoke.check_graph(run, "x")


def _pass(outs, keys, traces, replays=None):
    waves = len(keys)
    return {"graphed": True, "outs": outs, "wave_keys": keys,
            "metrics": {"step_traces": 1, "graph_replays": 4,
                        "decode_ticks": 4, "prefill_waves": waves,
                        "prefill_graph_replays": (waves if replays is None
                                                  else replays),
                        "prefill_traces": traces}}


@pytest.mark.parametrize("warm,match", [
    (_pass([[1, 2]], [(8, 1), (16, 1)], 2), None),
    (_pass([[1, 3]], [(8, 1), (16, 1)], 2), "tokens differ"),
    (_pass([[1, 2]], [(8, 1), (16, 2)], 3), "built again"),
    (_pass([[1, 2]], [(8, 1), (16, 1)], 2, replays=1), "prefill replays")])
def test_warm_pass_builds_nothing(warm, match):
    """The warm pass: no new build, a replay a wave, the cold tokens."""
    run = dict(_pass([[1, 2]], [(8, 1), (16, 1)], 2), warm=warm)
    with nullcontext() if match is None else pytest.raises(
            chip_smoke.CheckFailed, match=match):
        chip_smoke.check_warm(run, "x")


@pytest.mark.parametrize("eager,identical,differing,first", [
    ([[1, 2, 3], [4, 5]], True, [], None),
    ([[1, 2, 3], [4, 6]], False, [1], [1, 1, 5, 6]),
    ([[1, 9, 3], [4, 6]], False, [0, 1], [0, 1, 2, 9]),
    ([[1, 2], [4, 5]], False, [0], [0, 2, 3, None])])
def test_twin_comparison(eager, identical, differing, first):
    got = chip_smoke.twin_comparison([[1, 2, 3], [4, 5]], eager)
    assert got == {"tokens_identical": identical,
                   "requests_differing": differing,
                   "first_difference": first}
    twin = dict(got, launches_identical=True, routes_identical=True)
    if identical:
        chip_smoke.check_twin(twin, "x")
    else:
        with pytest.raises(chip_smoke.CheckFailed, match="eager"):
            chip_smoke.check_twin(twin, "x")


def test_twin_comparison_needs_every_request():
    with pytest.raises(ValueError):
        chip_smoke.twin_comparison([[1]], [[1], [2]])


# ---- the speculative phases (4h-4k) -------------------------------------------

def test_script_drafter_replays_the_stream():
    """A scripted drafter proposes the request's known continuation after
    what it has generated, column 2 changed when corrupted."""
    p = np.array([7, 8, 9], np.int32)
    stream = [1, 2, 3, 4, 5, 6]
    d = chip_smoke.ScriptDrafter(p, stream, 4, vocab=10, corrupt=False)
    assert d.propose(np.r_[p, 1]).tolist() == [2, 3, 4, 5]
    assert d.propose(np.r_[p, 1, 2, 3, 4]).tolist() == [5, 6]
    assert d.propose(np.r_[p, stream]).tolist() == []
    c = chip_smoke.ScriptDrafter(p, stream, 4, vocab=10, corrupt=True)
    assert c.propose(np.r_[p, 1]).tolist() == [2, 3, 5, 5]
    assert c.propose(np.r_[p, 1, 2, 3, 4]).tolist() == [5, 6]
    assert d.kind == "scripted" and not d.uses_device


def test_spec_submit_kw_halves_the_requests():
    prompts = [np.array([i], np.int32) for i in range(8)]
    kw = chip_smoke.spec_submit_kw(prompts, [[1, 2]] * 8, vocab=10)
    kinds = [getattr(k["drafter"], "kind", k["drafter"]) for k in kw]
    assert kinds == ["scripted", "ngram"] * 4
    assert [k["drafter"].corrupt for k in kw[::2]] == [False, True] * 2


def test_spec_fields_reports_beside_the_base_phase():
    def run(outs, wall, p50):
        return {"outs": outs, "wall": wall, "peak_memory_gb": 1.0,
                "metrics": {"tpot_ms": {"p50": p50},
                            "decode_step_ms": {"p50": 9.0},
                            "spec": {"accepted_per_step": {"count": 3,
                                                           "mean": 2.5}}}}
    got = chip_smoke.spec_fields(run([[1, 2], [3, 4]], 2.0, 5.0),
                                 run([[1, 2], [3, 5]], 4.0, 9.0))
    assert got["same_tokens_as_non_spec"] == "1/2"
    assert got["accepted_per_step_mean"] == 2.5
    assert got["this_run"]["tok_per_s"] == 2.0
    assert got["non_spec_phase"]["tok_per_s"] == 1.0
    assert got["this_run"]["tpot_ms_p50"] == 5.0


_SPEC_LAUNCHES = {n: 0 for n in chip_smoke.ATTENTION_KERNELS}


@pytest.mark.parametrize("launches,routes,match", [
    (dict(_SPEC_LAUNCHES, flash_attention_fwd_paged=32 * 7, rms_norm=5), {},
     None),
    # the verify tick on K1-paged instead: a kernel off the path
    (dict(_SPEC_LAUNCHES, flash_attention_fwd_paged=32 * 2,
          decode_attention_paged=32 * 5, rms_norm=5), {}, "launched"),
    (dict(_SPEC_LAUNCHES, flash_attention_fwd_paged=32 * 7, rms_norm=5),
     {"rms_norm/plain": 1}, "plain routes"),
    (dict(_SPEC_LAUNCHES, flash_attention_fwd_paged=32 * 7,
          decode_attention=1, rms_norm=5), {}, "off this path")])
def test_check_attention_launches(launches, routes, match):
    """32 launches a unit (verify ticks + waves here), no other attention
    kernel, no plain route."""
    m = {"decode_ticks": 5, "prefill_waves": 2, "ticks": 7}
    want = chip_smoke.attention_launches(
        m, {"flash_attention_fwd_paged": ("tick", "wave")})
    assert want == {"flash_attention_fwd_paged": 32 * 7}
    with nullcontext() if match is None else pytest.raises(
            chip_smoke.CheckFailed, match=match):
        chip_smoke.check_attention_launches("x", launches, routes, want)


def test_attention_launches_units():
    """The units: decode or verify ticks, waves, chunks, every tick."""
    m = {"decode_ticks": 3, "prefill_waves": 2, "mixed_ticks": 4,
         "ticks": 7}
    assert chip_smoke.attention_launches(m, {
        "a": ("tick",), "b": ("wave",), "c": ("mixed",), "d": ("ticks",),
        "e": ("ticks", "mixed")}) == {"a": 96, "b": 64, "c": 128,
                                      "d": 224, "e": 352}


def test_spec_phases_cover_each_layout():
    """4h contiguous, 4i paged, 4j int8 paged + int8 weights: each on its
    layout's verify-window kernel, and every kernel named a known one."""
    labels = [p[1] for p in chip_smoke.SPEC_PHASES]
    assert labels == ["serving_spec", "serving_spec_paged",
                      "serving_spec_int8"]
    for _, _, kw, attention in chip_smoke.SPEC_PHASES:
        assert set(attention) <= set(chip_smoke.ATTENTION_KERNELS)
    assert chip_smoke.SPEC_PHASES[2][2]["int8_weights"]


# ---- the dit phase and K2's head-dim rows ------------------------------------

def test_dit_constants_are_dit_xl_2():
    """The dit phase runs DiT-XL/2 at its published width, not cut."""
    from paddle_tpu_torch.models import dit_xl_2_config
    cfg = dit_xl_2_config(dtype="bfloat16")
    assert (cfg.depth, cfg.num_heads, cfg.head_dim, cfg.num_patches,
            cfg.hidden_size, cfg.num_classes, cfg.learn_sigma) == (
                chip_smoke.DIT_DEPTH, chip_smoke.DIT_HEADS,
                chip_smoke.DIT_HEAD_DIM, chip_smoke.DIT_TOKENS, 1152, 1000,
                True)
    assert chip_smoke.DIT_BATCH == 2 * chip_smoke.DIT_LABELS == 16
    assert (chip_smoke.DIT_STEPS, chip_smoke.DIT_CFG) == (50, 4.0)


def test_dit_perturbed_weights_reach_the_output():
    """Off AdaLN-Zero every gate and the final projection are nonzero, so
    the gates hold attention's error; at the reference's init they are 0
    and the output would not depend on attention at all."""
    from paddle_tpu_torch.models import tiny_dit_config
    m = chip_smoke._dit_perturbed(torch, tiny_dit_config(), "cpu")
    sd = m.state_dict()
    for name in ("blocks.0.ada", "blocks.1.ada_b", "final.ada",
                 "final.ada_b", "final.linear"):
        assert sd[name].std() > 0.01, name
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    t, y = torch.tensor([5, 500]), torch.tensor([1, 10])
    with torch.no_grad():
        out = m(x, t, y)
        m.blocks[0].qkv.mul_(2.0)
        assert not torch.equal(out, m(x, t, y))


def test_d72_entry_and_phase_order():
    """The kernels line carries K2's head-dim-72 launches under an entry
    of their own, pointing at the repo's source and the reference kernel;
    phase 2 runs the head-dim rows; the dit phase runs after the serving
    models are freed and before training."""
    info = chip_smoke.KERNEL_INFO["flash_attention_fwd/d72"]
    root = Path(chip_smoke.__file__).resolve().parent
    assert info["route"] == "cuda" and (root / info["source"]).is_file()
    path, line = info["replaces"].split(":")
    src = (root / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def _fwd_kernel")
    import inspect
    kernels_src = inspect.getsource(chip_smoke.phase_kernels)
    assert "phase_head_dim_rows(" in kernels_src
    main_src = inspect.getsource(chip_smoke.main)
    freed = main_src.index("del model, qmodel")
    assert freed < main_src.index("phase_dit(") < main_src.index(
        "phase_dit_train(") < main_src.index("phase_training(")
    assert main_src.index("phase_serving_spec_chunked_model(") < freed


# ---- the dit_train phase ----------------------------------------------------

@pytest.mark.parametrize("name,replaces", [
    ("flash_attention_bwd_dq/d72", "def _bwd_dq_kernel"),
    ("flash_attention_bwd_dkv/d72", "def _bwd_dkv_kernel")])
def test_d72_backward_entries(name, replaces):
    """The kernels line carries K5 / K6's head-dim-72 launches (dit_train)
    under entries of their own, each pointing at the repo's source and at
    the reference kernel it replaces; phase 2 has their main rows."""
    info = chip_smoke.KERNEL_INFO[name]
    root = Path(chip_smoke.__file__).resolve().parent
    assert info["route"] == "cuda" and (root / info["source"]).is_file()
    path, line = info["replaces"].split(":")
    assert (root / path).read_text().splitlines()[int(line) - 1].startswith(
        replaces)
    assert name in chip_smoke.DIT_BWD
    import inspect
    rows_src = inspect.getsource(chip_smoke.phase_head_dim_rows)
    assert "DIT_BWD" in rows_src and "k5_k6_rows(" in rows_src
    assert "backward_rows(" in inspect.getsource(chip_smoke.k5_k6_rows)


def test_dit_train_settings_are_the_papers():
    """32 latents a step (the paper's 256 over 8 cards), AdamW at 1e-4,
    8 steps with 2 untimed, gate (a) on 8 latents, 10 % null labels."""
    assert (chip_smoke.DIT_TRAIN_BATCH, chip_smoke.DIT_TRAIN_STEPS,
            chip_smoke.DIT_TRAIN_UNTIMED, chip_smoke.DIT_GRAD_BATCH) == (
                32, 8, 2, 8)
    assert (chip_smoke.DIT_TRAIN_LR, chip_smoke.DIT_LABEL_DROP) == (1e-4,
                                                                    0.1)


@pytest.mark.parametrize("n,nulls", [(8, 1), (32, 3), (4, 1)])
def test_dit_batch(n, nulls):
    """x = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise with the target the
    noise, t in [0, 1000), round(10 %) (at least one) null labels, the
    same arrays from the same seed."""
    from paddle_tpu_torch.models import diffusion_schedule, tiny_dit_config
    cfg = tiny_dit_config()
    b = chip_smoke.dit_batch(cfg, n, seed=3)
    assert b["x"].shape == b["target"].shape == (n, 4, 8, 8)
    assert b["x"].dtype == b["target"].dtype == np.float32
    assert ((b["t"] >= 0) & (b["t"] < 1000)).all()
    assert int((b["y"] == cfg.num_classes).sum()) == nulls
    assert ((b["y"] >= 0) & (b["y"] <= cfg.num_classes)).all()
    abar = diffusion_schedule().numpy()[b["t"]][:, None, None, None]
    x0 = (b["x"] - np.sqrt(1 - abar) * b["target"]) / np.sqrt(abar)
    assert abs(float(x0.std()) - 1.0) < 0.2
    again = chip_smoke.dit_batch(cfg, n, seed=3)
    assert all(np.array_equal(b[k], again[k]) for k in b)
    assert not np.array_equal(b["x"], chip_smoke.dit_batch(cfg, n, 4)["x"])


def test_dit_train_flops_count_the_products():
    """6 FLOPs a multiply-add of every product: counted by hand for the
    tiny DiT, and DiT-XL/2's 32-latent step."""
    from paddle_tpu_torch.models import dit_xl_2_config, tiny_dit_config
    c = tiny_dit_config()                   # h 64, 16 tokens, depth 2
    h, n, b = 64, 16, 3
    tokens = b * n * (2 * (3 * h * h + h * h + 2 * 4 * h * h)
                      + 16 * h + h * 32)
    latents = b * (2 * 6 * h * h + 2 * h * h + 256 * h + h * h
                   + 2 * 2 * n * n * h)
    assert chip_smoke.dit_train_flops(c, b) == 6 * (tokens + latents)
    assert chip_smoke.dit_train_flops(dit_xl_2_config(), 32) == \
        22_775_312_941_056


def _tiny_dit():
    from paddle_tpu_torch.models import tiny_dit_config
    return chip_smoke._dit_perturbed(torch, tiny_dit_config(), "cpu")


def test_grad_gate_passes_equal_paths_and_fails_a_wrong_one(capsys):
    """On the CPU both paths are the plain version, so the gate passes; a
    kernel path whose loss is off by half fails it."""
    from paddle_tpu_torch.ops._dispatch import in_reference_mode
    m = _tiny_dit()
    b = {k: torch.from_numpy(v) for k, v in chip_smoke.dit_batch(
        m.config, 4, seed=1).items()}

    def make32():
        return m

    chip_smoke.grad_gate(torch, m, make32, lambda mod: mod.compute_loss(**b),
                         "g", {"config": "tiny"})
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "g" and line["config"] == "tiny"
    assert line["grad_rel_l2_kernel_vs_f32"] == 0.0
    with pytest.raises(chip_smoke.CheckFailed, match="kernel-path"):
        chip_smoke.grad_gate(
            torch, m, make32, lambda mod: mod.compute_loss(**b) * (
                1.0 if in_reference_mode() else 1.5), "g", {})


def test_tiny_card_vs_cpu_on_one_device():
    """The comparison's plumbing with the CPU on both sides: equal losses
    and parameters, a nonzero update, the CPU route counted."""
    base = _tiny_dit()
    batches = [chip_smoke.dit_batch(base.config, 4, seed=i)
               for i in range(4)]
    res = chip_smoke.tiny_card_vs_cpu(torch, base, batches,
                                      torch.device("cpu"))
    assert res["losses_card"] == res["losses_cpu"]
    assert res["param_diff_l2"] == 0.0 and res["update_l2"] > 0
    assert res["routes"] == {"flash_attention/plain": 2 * 4}
    chip_smoke.check_tiny(res, "x")
    bad = dict(res, param_diff_l2=res["update_l2"] * 2e-3)
    with pytest.raises(chip_smoke.CheckFailed, match="parameters"):
        chip_smoke.check_tiny(bad, "x")


def test_recording_backward_keeps_first_and_last(monkeypatch):
    """The recorder sees K5 / K6 where ``FlashAttention.backward`` looks
    them up, keeps each wrapper's first and latest call, restores the
    wrappers on exit; ``same_bits`` launches the kept calls again."""
    from paddle_tpu_torch.ops import attention
    drift = {"n": 0}

    def dq(q, *args, **kwargs):
        return q * 2

    def dkv(q, *args, **kwargs):
        drift["n"] += 1
        return q + drift["n"], q

    monkeypatch.setattr(attention, "flash_attention_bwd_dq_cuda", dq)
    monkeypatch.setattr(attention, "flash_attention_bwd_dkv_cuda", dkv)
    calls = {}
    with chip_smoke.recording_backward(calls):
        for i in range(3):
            x = torch.full((2,), float(i))
            attention.flash_attention_bwd_dq_cuda(x, causal=False)
            attention.flash_attention_bwd_dkv_cuda(x)
    assert attention.flash_attention_bwd_dq_cuda is dq
    assert attention.flash_attention_bwd_dkv_cuda is dkv
    first, last = calls["flash_attention_bwd_dq_cuda"]
    assert float(first[1][0][0]) == 0.0 and float(last[1][0][0]) == 2.0
    assert first[2] == {"causal": False}
    assert chip_smoke.same_bits(torch, calls) == {
        "flash_attention_bwd_dq_cuda": True,
        "flash_attention_bwd_dkv_cuda": False}


# ---- the generate, qwen2_vl and qwen2_vl_train phases ---------------------------

@pytest.mark.parametrize("name,replaces", [
    ("flash_attention_fwd/d64", "def _fwd_kernel"),
    ("flash_attention_fwd/cross", "def _fwd_kernel"),
    ("flash_attention_bwd_dq/d64", "def _bwd_dq_kernel"),
    ("flash_attention_bwd_dkv/d64", "def _bwd_dkv_kernel")])
def test_qwen2_vl_entries(name, replaces):
    """The kernels line carries K2 at the vision tower's head dim 64 and at
    the cross-attention's shape, and K5 / K6 at 64, under entries of their
    own, each pointing at the repo's source and the reference kernel;
    phase 2 has their main rows."""
    info = chip_smoke.KERNEL_INFO[name]
    root = Path(chip_smoke.__file__).resolve().parent
    assert info["route"] == "cuda" and (root / info["source"]).is_file()
    path, line = info["replaces"].split(":")
    assert (root / path).read_text().splitlines()[int(line) - 1].startswith(
        replaces)
    import inspect
    rows_src = inspect.getsource(chip_smoke.phase_head_dim_rows)
    assert (f'"{name}"' in rows_src if name.startswith("flash_attention_fwd")
            else name in chip_smoke.QWEN_BWD and "QWEN_BWD" in rows_src)


def test_generation_phases_order():
    """``generate`` runs on phase 3's models before they are freed (no
    second copy of the 8B weights), after the serving phases; the Qwen2-VL
    phases run after dit_train and before phase 5."""
    import inspect
    main_src = inspect.getsource(chip_smoke.main)
    freed = main_src.index("del model, qmodel")
    assert main_src.index("phase_serving_spec_chunked_model(") \
        < main_src.index("phase_generate(torch, model, qmodel") < freed
    assert main_src.index("phase_dit_train(") \
        < main_src.index("phase_qwen2_vl(") \
        < main_src.index("phase_qwen2_vl_train(") \
        < main_src.index("phase_training(")


def test_shape_counts_credit_each_replay():
    """K2, K5 and K6 count their launches by (head_dim, Sq, Skv, causal)
    beside ``.launches``.  A region recorded around a capture takes its
    by-shape counts out of the live counters and each replay credits them
    again, as an eager run of the region would; a reset clears them."""
    from paddle_tpu_torch import ops
    fwd = ops.KERNELS["flash_attention_fwd"]
    dq = ops.KERNELS["flash_attention_bwd_dq"]
    assert {n for n, fn in ops.KERNELS.items() if hasattr(fn, "by_shape")} \
        == {"flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv"}
    ops.reset_launch_counts()
    fwd.by_shape[(64, 256, 256, False)] += 1
    with ops.ReplayCounts.record() as rc:
        fwd.by_shape[(128, 1, 256, False)] += 2
        dq.by_shape[(128, 64, 64, True)] += 1
    assert ops.shape_counts() == {
        ("flash_attention_fwd", 64, 256, 256, False): 1}
    rc.add(3)
    assert ops.shape_counts() == {
        ("flash_attention_fwd", 64, 256, 256, False): 1,
        ("flash_attention_fwd", 128, 1, 256, False): 6,
        ("flash_attention_bwd_dq", 128, 64, 64, True): 3}
    ops.reset_launch_counts()
    assert ops.shape_counts() == {}


def test_qwen_batch_is_the_reference_recipe():
    """ids[:, :-1] in and ids[:, 1:] as labels, seeded, with images of the
    config's size."""
    from paddle_tpu_torch.models import tiny_qwen2_vl_config
    cfg = tiny_qwen2_vl_config()
    a = chip_smoke.qwen_batch(torch, cfg, 3, 16, seed=4)
    b = chip_smoke.qwen_batch(torch, cfg, 3, 16, seed=4)
    assert a["input_ids"].shape == a["labels"].shape == (3, 16)
    assert a["pixel_values"].shape == (3, 3, 16, 16)
    np.testing.assert_array_equal(a["input_ids"][:, 1:], a["labels"][:, :-1])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_qwen_model_opens_the_cross_gates():
    """The phases' Qwen2-VL has its cross gates at 0.5, so the image
    reaches the logits (at init tanh(0) = 0)."""
    from paddle_tpu_torch.models import tiny_qwen2_vl_config
    cfg = tiny_qwen2_vl_config()
    m = chip_smoke._qwen_model(torch, cfg, "cpu")
    assert all(float(c.gate) == 0.5 for c in m.cross)
    ids, pix = chip_smoke.qwen_inputs(torch, cfg, 2, 5, seed=1)
    with torch.no_grad():
        a = m(torch.from_numpy(ids), torch.from_numpy(pix))
        b = m(torch.from_numpy(ids), torch.from_numpy(2 * pix))
    assert float((a - b).abs().max()) > 1e-4


def test_grad_gate_reports_one_element_tensors_apart(capsys):
    """A one-element parameter (Qwen2-VL's cross gate) is reported apart
    with GRAD_SCALAR_TOL; a kernel path that moves only its gradient, by
    half, fails the gate."""
    from paddle_tpu_torch.models import tiny_qwen2_vl_config
    from paddle_tpu_torch.ops._dispatch import in_reference_mode
    m = chip_smoke._qwen_model(torch, tiny_qwen2_vl_config(), "cpu")
    b = {k: torch.from_numpy(v) for k, v in chip_smoke.qwen_batch(
        torch, m.config, 2, 8, seed=3).items()}
    gate = m.cross[0].gate
    g_true = torch.autograd.grad(m.compute_loss(**b), gate)[0]

    def loss(mod):
        out = mod.compute_loss(**b)
        if in_reference_mode():
            return out
        return out + 0.5 * (g_true * mod.cross[0].gate).sum()

    chip_smoke.grad_gate(torch, m, lambda: m,
                         lambda mod: mod.compute_loss(**b), "g", {})
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(line["one_element_tensors"]) == {"cross.0.gate",
                                                "cross.1.gate"}
    assert line["tol_one_element"] == chip_smoke.GRAD_SCALAR_TOL
    assert line["worst_tensor_ratio"]["name"] not in \
        line["one_element_tensors"]
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.grad_gate(torch, m, lambda: m, loss, "g", {})


# ---- the float32 head_dim-128 builds: phase 2's rows, qwen2_vl_f32 and
# serving_f32 -----------------------------------------------------------------

F32_BUILDS = ("decode_attention", "decode_attention_int8",
              "decode_attention_paged", "decode_attention_paged_int8",
              "flash_attention_fwd", "flash_attention_fwd_paged",
              "flash_attention_fwd_paged_int8", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


@pytest.mark.parametrize("build", F32_BUILDS)
def test_f32_d128_entries(build):
    """Every float32 head_dim-128 build has an entry of its own in the
    kernels line, its namesake's source and reference kernel; phase 2
    records its rows under it, and a main-path phase sets its launches
    (serving_f32's engines or qwen2_vl_f32's train step)."""
    import inspect
    name = build + chip_smoke.F32_D128
    assert chip_smoke.KERNEL_INFO[name] == chip_smoke.KERNEL_INFO[build]
    assert build in chip_smoke.F32_D128_FUNCTIONS
    rows_src = inspect.getsource(chip_smoke.phase_f32_d128_rows)
    base = build.replace("_int8", "")       # rows name "..._int8" builds
    head_dim_src = inspect.getsource(chip_smoke.phase_head_dim_rows)
    assert (f'"{base}' in rows_src
            or f'"{build}" + F32_D128' in head_dim_src
            or build in chip_smoke.TRAIN_KERNELS
            and "TRAIN_KERNELS)" in head_dim_src.split("f32_bwd = ")[1])
    engines = {n for _, _, att in chip_smoke.F32_ENGINES for n in att}
    assert build in engines or build in chip_smoke.TRAIN_KERNELS


def test_f32_d128_ptxas_finds_each_build_and_its_spills():
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{t}"
        f"PKfS1_' for 'sm_90a'\n"
        f"    0 bytes stack frame, {8 if 'dkv' in t else 0} bytes spill "
        f"stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {100 + i} registers, used 1 barriers"
        for i, tags in enumerate(chip_smoke.F32_D128_FUNCTIONS.values())
        for t in tags)
    got = chip_smoke.f32_d128_ptxas({"lib": log})
    assert set(got) == set(chip_smoke.F32_D128_FUNCTIONS)
    assert all(r is not None for fns in got.values() for r in fns.values())
    spills = {b for b, fns in got.items() for r in fns.values()
              if r["spill_stores"]}
    assert spills == {"flash_attention_bwd_dkv"}
    # a library built by an earlier process leaves no report: None
    assert all(r is None for fns in chip_smoke.f32_d128_ptxas({}).values()
               for r in fns.values())


def test_qwen_generation_want_counts_by_shape():
    """qwen2_vl and qwen2_vl_f32 expect the same launches of Qwen2VLConfig()
    a generate call: K2 the tower's 2 (D 64), the prefill's 4 (causal D
    128), the cross layers' 2 at the prefill and 2 a decode step."""
    from paddle_tpu_torch.models import Qwen2VLConfig
    cfg = Qwen2VLConfig()
    want, shapes = chip_smoke.qwen_generation_want(cfg, 2)
    new, prompt, patches = (chip_smoke.QWEN_NEW, chip_smoke.QWEN_PROMPT,
                            chip_smoke.QWEN_PATCHES)
    assert want == {"flash_attention_fwd": 2 + 4 + 2 * new,
                    "decode_attention": 4 * (new - 1),
                    "rms_norm": 11 * new}
    assert sum(shapes.values()) == want["flash_attention_fwd"]
    assert shapes[("flash_attention_fwd", 128, 1, patches, False)] \
        == 2 * (new - 1)
    assert shapes[("flash_attention_fwd", 128, prompt, prompt, True)] == 4


@pytest.mark.parametrize("label", ["contiguous", "paged", "int8_paged",
                                   "int8_contiguous"])
def test_serving_f32_launch_contract(label):
    """Each serving_f32 engine owes its decode kernel 32 launches a tick and
    its wave kernel 32 a wave; an attention kernel off its path, a short
    count or a plain route fails the phase."""
    (_, _, attention), = [e for e in chip_smoke.F32_ENGINES if e[0] == label]
    m = {"decode_ticks": 15, "prefill_waves": 3, "ticks": 18}
    want = chip_smoke.attention_launches(m, attention)
    assert sorted(want.values()) == [96, 480]
    launches = {n: 0 for n in chip_smoke.ATTENTION_KERNELS}
    launches.update(want, rms_norm=1)
    chip_smoke.check_attention_launches(label, launches, {}, want)
    for bad_launches, routes in (
            (dict(launches, **{n: want[n] - 1 for n in list(want)[:1]}), {}),
            (dict(launches, decode_attention_paged_int8=7
                  if label != "int8_paged" else 0,
                  decode_attention=7 if label == "int8_paged" else 0), {}),
            (launches, {"decode_attention/plain": 1})):
        with pytest.raises(chip_smoke.CheckFailed):
            chip_smoke.check_attention_launches(label, bad_launches, routes,
                                                want)


def test_serving_f32_prompts():
    prompts = chip_smoke.f32_serving_prompts(32000)
    lens = [p.size for p in prompts]
    assert len(prompts) == 8 and min(lens) >= 5 and max(lens) <= 1500
    assert max(lens) + chip_smoke.F32_NEW_TOKENS <= chip_smoke.F32_L
    shared = [p for p in prompts[::2]]
    assert all(np.array_equal(p[:512], shared[0][:512]) for p in shared)
    assert not any(np.array_equal(p[:512], shared[0][:512])
                   for p in prompts[1::2] if p.size >= 512)


def test_logit_gate():
    want = [torch.tensor([[1.0, -4.0]]), torch.tensor([[2.0, 0.5]])]
    ok = chip_smoke.logit_gate([w + 3e-4 for w in want], want)
    assert ok["tol"] == pytest.approx(4.0 * chip_smoke.F32_LOGIT_TOL)
    chip_smoke.check_logit_gate(ok, "ok")
    for got in ([w + 5e-4 for w in want],
                [want[0], want[1] * float("nan")]):
        with pytest.raises(chip_smoke.CheckFailed):
            chip_smoke.check_logit_gate(chip_smoke.logit_gate(got, want),
                                        "bad")


def test_f32_phases_order():
    """serving_f32 runs first once the bf16 models are freed (26.9 GB of
    float32 Llama weights, a 17 GB cache and an eager wave's 8.6 GB
    sub-cache leave little room), qwen2_vl_f32 after qwen2_vl_train and
    before phase 5, serving_f32_tinyllama right after serving_tinyllama
    and training_f32_d256 right after training_f16; the eager twin serves
    as many tokens as its graphed run."""
    import inspect
    main_src = inspect.getsource(chip_smoke.main)
    assert main_src.index("del model, qmodel") \
        < main_src.index("phase_serving_f32(") \
        < main_src.index("phase_dit(") \
        < main_src.index("phase_qwen2_vl_train(") \
        < main_src.index("phase_qwen2_vl_f32(") \
        < main_src.index("phase_training(")
    # serving_f32_tinyllama right after serving_tinyllama, and
    # training_f32_d256 right after training_f16, each behind the loop's
    # memory line
    phases = [ln.strip() for ln in main_src.splitlines()
              if ln.strip().startswith("lambda: phase_")]
    names = [ln.split("phase_")[1].split("(")[0] for ln in phases]
    assert names.index("serving_f32_tinyllama") \
        == names.index("serving_tinyllama") + 1
    assert names.index("training_f32_d256") \
        == names.index("training_f16") + 1
    assert main_src.index('"phase": "memory"') \
        > main_src.index("lambda: phase_training_f32_d256(")
    # the chunked and spec loops leave ``m`` on the int8 model: it is
    # dropped with the other names, or its 8.8 GB stay on the card
    assert "del model, qmodel, m\n" in main_src
    assert "new_tokens=F32_NEW_TOKENS" in inspect.getsource(
        chip_smoke.phase_serving_f32).split("eager_twin(")[1][:200]


# ---- bf16 below head_dim 128: phase 2's rows and serving_tinyllama ---------

@pytest.mark.parametrize("build", chip_smoke.BF16_D64_BUILDS)
def test_bf16_d64_entries(build):
    """Every bf16 build of K1 and K2-paged has a ``/bf16_d64`` entry in the
    kernels line, its namesake's source and reference kernel; phase 2
    records its rows under it, and serving_tinyllama's engines set its
    launches."""
    import inspect
    name = build + chip_smoke.BF16_D64
    assert chip_smoke.KERNEL_INFO[name] == chip_smoke.KERNEL_INFO[build]
    rows_src = inspect.getsource(chip_smoke.phase_bf16_head_dim_rows)
    assert f'row("{build.replace("_int8", "")}' in rows_src
    engines = {n for _, _, att in chip_smoke.F32_ENGINES for n in att}
    assert build in engines
    # the shared serving phase sets the launches of its suffix's entries
    assert "kernels[name + suffix]" in inspect.getsource(
        chip_smoke.serve_llama)
    assert "BF16_D64,BF16_D64_BUILDS" in "".join(inspect.getsource(
        chip_smoke.phase_serving_tinyllama).split())


def test_bf16_rows_cover_the_head_dims():
    """The rows run at the tiny config's 16, TinyLlama's 64, 72 (an int8
    row of D % 16 == 8 bytes: the 8-byte copies) and 96, and above 128 at
    136 and 200 (the 8-byte copies, K2-paged-int8's CP8 staging), 192 and
    the Gemma-2B-wide Llama's 256, every one a head dim the bf16 forward
    builds take."""
    from paddle_tpu_torch.ops.cuda import BF16_HEAD_DIMS
    dims = chip_smoke.BF16_SMALL_DIMS
    assert set(dims) == {16, 64, 72, 96} and set(dims) <= BF16_HEAD_DIMS
    assert any(d % 16 == 8 for d in dims)
    wide = chip_smoke.BF16_WIDE_DIMS
    assert set(wide) == {136, 192, 200, 256} and set(wide) <= BF16_HEAD_DIMS
    assert {d for d in wide if d % 16 == 8} == {136, 200}


def test_tinyllama_is_the_published_config():
    """serving_tinyllama serves TinyLlama-1.1B's published widths
    (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T config.json), not
    cut: head_dim 64, 8 query heads a KV head, 22 layers."""
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig(**chip_smoke.TINYLLAMA)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.max_position_embeddings) == (
                32000, 2048, 5632, 22, 32, 4, 2048)
    assert (cfg.rms_norm_eps, cfg.rope_theta, cfg.tie_word_embeddings,
            cfg.dtype) == (1e-5, 10000.0, False, "bfloat16")
    assert cfg.head_dim == 64
    assert (chip_smoke.TL_HEADS, chip_smoke.TL_KV_HEADS) == (
        cfg.num_attention_heads, cfg.num_key_value_heads)
    # the shared system prompt fills whole paged blocks
    assert 512 % chip_smoke.TL_BLOCK_LEN == 0


def test_tinyllama_phase_order():
    """serving_tinyllama runs right after serving_f32, behind the main
    loop's ``memory`` line; phase 2 adds its rows after the float32 ones."""
    import inspect
    main_src = inspect.getsource(chip_smoke.main)
    loop = main_src.split("for phase in (")[1].split("):")[0]
    assert loop.index("phase_serving_f32(") \
        < loop.index("phase_serving_tinyllama(") < loop.index("phase_dit(")
    assert '"phase": "memory"' in main_src.split("for phase in (")[1]
    k_src = inspect.getsource(chip_smoke.phase_kernels)
    assert k_src.index("phase_f32_d128_rows(") \
        < k_src.index("phase_bf16_head_dim_rows(")


def test_tinyllama_launch_contract():
    """The engines owe their kernels 22 launches a unit (TinyLlama's
    layers), not 32."""
    m = {"decode_ticks": 15, "prefill_waves": 3, "ticks": 18,
         "mixed_ticks": 4}
    att = {"decode_attention": ("ticks",),
           "flash_attention_fwd_paged": ("mixed",)}
    assert chip_smoke.attention_launches(m, att, 22) == {
        "decode_attention": 22 * 18, "flash_attention_fwd_paged": 22 * 4}


def test_truth_gate():
    """serving_tinyllama holds a bf16 session as an int8 cache's: the
    kernel path within 1.2x the plain path's distance from the float32
    truth, finite."""
    truth = [torch.tensor([[1.0, -4.0]]), torch.tensor([[2.0, 0.5]])]
    plain = [t + 1e-2 for t in truth]

    def gate(got):
        return dict(chip_smoke.logit_gate(got, plain),
                    **chip_smoke.int8_gate(got, plain, truth))
    ok = gate([t - 1.1e-2 for t in truth])
    assert ok["tol_kernel_vs_f32_cache"] == pytest.approx(1.2e-2)
    chip_smoke.check_logit_gate(ok, "ok")
    for got in ([t + 1.3e-2 for t in truth],
                [truth[0], truth[1] * float("nan")]):
        with pytest.raises(chip_smoke.CheckFailed):
            chip_smoke.check_logit_gate(gate(got), "bad")


# ---- float16: phase 2's /f16 rows and serving_f16 ---------------------------

@pytest.mark.parametrize("build", chip_smoke.F16_BUILDS)
def test_f16_entries(build):
    """Every float16 forward build (the K1 family, K2 in every layout, K4)
    has an ``/f16`` entry in the kernels line, its namesake's source and
    reference kernel, ptxas tags; phase 2 records its rows under it and
    serving_f16's engines set its launches."""
    import inspect
    name = build + chip_smoke.F16
    assert chip_smoke.KERNEL_INFO[name] == chip_smoke.KERNEL_INFO[build]
    assert chip_smoke.F16_FUNCTIONS[build]
    if build == "int8_matmul":
        assert 'record("int8_matmul" + (F16' in inspect.getsource(
            chip_smoke.phase_kernels)
    else:
        engines = {n for _, _, att in chip_smoke.F32_ENGINES for n in att}
        assert build in engines
    assert "F16,F16_BUILDS" in "".join(inspect.getsource(
        chip_smoke.phase_serving_f16).split())
    assert "phase_bf16_head_dim_rows(" in inspect.getsource(
        chip_smoke.phase_f16_rows)


def test_f16_rows_cover_the_head_dims():
    """The float16 rows run at Llama-2-7B's 128, the narrow and wide
    instances' 64 and 256, and 72 and 136 (D % 16 == 8 on both tile
    widths: the 8-byte int8 copies and the CP8 staging), every one a head
    dim the float16 builds take; the tolerance is bf16's scaled by
    float16's 8x finer rounding."""
    from paddle_tpu_torch.ops.cuda import BF16_HEAD_DIMS
    dims = chip_smoke.F16_DIMS
    assert set(dims) == {64, 72, 128, 136, 256} and set(dims) <= \
        BF16_HEAD_DIMS
    assert {d for d in dims if d % 16 == 8} == {72, 136}
    assert chip_smoke.L27_HEADS == 32
    import inspect
    assert "f16: (2e-3, 2e-3)" in inspect.getsource(
        chip_smoke.phase_kernels)


def test_llama2_7b_is_the_published_config():
    """serving_f16 serves ``LlamaConfig(dtype="float16")``, which is
    meta-llama/Llama-2-7b-hf's config.json as published ("torch_dtype":
    "float16"), not cut: 32 layers of 32 / 32 heads of 128; 6.74 B
    parameters, 13.5 GB."""
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig(**chip_smoke.F16_WIDTHS)
    assert chip_smoke.F16_WIDTHS == {"dtype": "float16"}
    assert {k: getattr(cfg, k) for k in chip_smoke.LLAMA2_7B} == \
        chip_smoke.LLAMA2_7B
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.max_position_embeddings) == (
                32000, 4096, 11008, 32, 32, 32, 4096)
    assert (cfg.rms_norm_eps, cfg.rope_theta, cfg.tie_word_embeddings,
            cfg.head_dim) == (1e-5, 10000.0, False, 128)
    h, i = cfg.hidden_size, cfg.intermediate_size
    layer = 4 * h * h + 3 * h * i + 2 * h
    params = 2 * cfg.vocab_size * h + cfg.num_hidden_layers * layer + h
    assert round(params / 1e9, 2) == 6.74
    assert round(2 * params / 1e9, 1) == 13.5


def test_f16_phase_order():
    """serving_f16 runs right after serving_d256, behind the main loop's
    ``memory`` line; phase 2 adds its float16 rows after the bf16 ones."""
    import inspect
    loop = inspect.getsource(chip_smoke.main).split("for phase in (")[1]
    loop = loop.split("):")[0]
    assert loop.index("phase_serving_d256(") \
        < loop.index("phase_serving_f16(") \
        < loop.index("phase_training_d256(")
    k_src = inspect.getsource(chip_smoke.phase_kernels)
    assert k_src.rindex("phase_bf16_head_dim_rows(") \
        < k_src.index("phase_f16_rows(")


def test_f16_launch_contract():
    """Llama-2-7B owes the attention kernels 32 launches a unit and K4 7 x
    32 + 1 = 225 a tick (the untied head quantized too)."""
    m = {"decode_ticks": 15, "prefill_waves": 2, "ticks": 17,
         "mixed_ticks": 6}
    att = {"decode_attention_paged_int8": ("tick",),
           "flash_attention_fwd_paged_int8": ("wave",)}
    assert chip_smoke.attention_launches(m, att, 32) == {
        "decode_attention_paged_int8": 32 * 15,
        "flash_attention_fwd_paged_int8": 32 * 2}
    cfg = chip_smoke.LLAMA2_7B
    k4 = 7 * cfg["num_hidden_layers"] + (
        0 if cfg["tie_word_embeddings"] else 1)
    assert k4 == 225 == chip_smoke.K4_PER_TICK
    import inspect
    assert "7 * layers + (0 if cfg.tie_word_embeddings else 1)" in \
        inspect.getsource(chip_smoke.serve_llama)


def test_f16_ptxas_pairs_each_instance_with_its_bf16_twin():
    """The f16_ptxas line reads the float16 libraries alone (their
    functions carry the bf16 ones' names), each instance beside its bf16
    twin's registers; the default libraries' reports are not overwritten
    by the float16 ones."""
    def log(src, regs, spill, elem="6__half"):
        return "\n".join(
            f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
            f"{t}vPK{elem}' for 'sm_90a'\n    0 bytes stack frame, {spill} bytes "
            f"spill stores, 0 bytes spill loads\nptxas info    : Used {regs} "
            f"registers, used 1 barriers"
            for build, tags in chip_smoke.F16_FUNCTIONS.items()
            if build.startswith(src) for t in tags)
    bf = "13__nv_bfloat16"
    build_log = {"decode_attention": log("decode", 150, 0, bf),
                 "decode_attention_f16": log("decode", 152, 0),
                 "flash_attention_fwd": log("flash", 168, 0, bf),
                 "flash_attention_fwd_f16": log("flash", 168, 8),
                 "int8_matmul": log("int8", 160, 0, bf),
                 "int8_matmul_f16": log("int8", 160, 0)}
    got = chip_smoke.f16_ptxas(build_log)
    assert set(got) == set(chip_smoke.F16_FUNCTIONS)
    k1 = got["decode_attention"]
    assert k1 and all(r["registers"] == 152 and r["bf16_registers"] == 150
                      for r in k1.values())
    assert all(r["spill_stores"] == 8
               for r in got["flash_attention_fwd_paged"].values())
    fns = chip_smoke.ptxas_of(build_log, {"decode_attention": (
        chip_smoke.F16_FUNCTIONS["decode_attention"][0],)})
    assert fns["decode_attention"][
        chip_smoke.F16_FUNCTIONS["decode_attention"][0]]["registers"] == 150
    assert chip_smoke.f16_ptxas({}) == dict.fromkeys(
        chip_smoke.F16_FUNCTIONS)


# ---- bf16 above head_dim 128: phase 2's /bf16_d256 rows and serving_d256 ----

@pytest.mark.parametrize("build", chip_smoke.BF16_D256_BUILDS)
def test_bf16_d256_entries(build):
    """Every bf16 forward build has a ``/bf16_d256`` entry in the kernels
    line, its namesake's source and reference kernel, ptxas tags of its
    256-wide instances; phase 2 records its rows under it, and
    serving_d256's engines set its launches."""
    import inspect
    name = build + chip_smoke.BF16_D256
    assert chip_smoke.KERNEL_INFO[name] == chip_smoke.KERNEL_INFO[build]
    assert all("Li256EE" in t
               for t in chip_smoke.BF16_D256_FUNCTIONS[build])
    rows_src = inspect.getsource(chip_smoke.phase_bf16_head_dim_rows)
    assert (f'row("{build.replace("_int8", "")}' in rows_src
            or build == "flash_attention_fwd" and "k2_rows(" in rows_src)
    engines = {n for _, _, att in chip_smoke.F32_ENGINES for n in att}
    assert build in engines
    assert "BF16_D256,BF16_D256_BUILDS" in "".join(inspect.getsource(
        chip_smoke.phase_serving_d256).split())


def test_bf16_d256_ptxas_finds_each_instance_and_its_spills():
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{t}"
        f"vPKf' for 'sm_90a'\n"
        f"    0 bytes stack frame, {8 if 'ELb1ELb1ELb1ELi' in t else 0} "
        f"bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {200 + i} registers, used 1 barriers"
        for i, tags in enumerate(chip_smoke.BF16_D256_FUNCTIONS.values())
        for t in tags)
    got = chip_smoke.ptxas_of({"lib": log}, chip_smoke.BF16_D256_FUNCTIONS)
    assert all(r is not None for fns in got.values() for r in fns.values())
    spills = {b for b, fns in got.items() for r in fns.values()
              if r["spill_stores"]}
    assert spills == {"flash_attention_fwd_paged_int8"}


def test_k1_instances_cover_each_ring_width():
    """The card line's ``k1_mma`` names every instance of the Hopper K1
    kernel: 128- and 256-wide ring rows, each at a constant D and padded,
    reached through a head dim each one runs."""
    inst = chip_smoke.K1_MMA_INSTANCES
    assert {(pad, pd) for _, pad, pd, _ in inst} == {
        (0, 128), (1, 128), (0, 256), (1, 256)}
    for _, pad, pd, d in inst:
        assert (d == pd) == (not pad) and d <= pd and (pd == 128) == (
            d <= 128)


def test_gemma2b_widths_are_the_published_config():
    """serving_d256 serves google/gemma-2b's published widths (config.json)
    as a Llama, not cut: head_dim 256, 8 query heads over one KV head, 18
    layers, tied embeddings; 2.51 B parameters."""
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig(**chip_smoke.GEMMA2B_WIDTHS)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads) == (256000, 2048, 16384, 18, 8, 1)
    assert (cfg.rms_norm_eps, cfg.rope_theta, cfg.tie_word_embeddings,
            cfg.dtype) == (1e-6, 10000.0, True, "bfloat16")
    assert cfg.head_dim == 256
    h, kv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
    layer = 2 * h * h + 2 * h * kv + 3 * h * cfg.intermediate_size + 2 * h
    params = cfg.vocab_size * h + cfg.num_hidden_layers * layer + h
    assert round(params / 1e9, 2) == 2.51


def test_d256_phase_order():
    """serving_d256 runs right after serving_tinyllama and training_d256
    right after it, each behind the main loop's ``memory`` line; phase 2
    adds its rows after the /bf16_d64 ones."""
    import inspect
    loop = inspect.getsource(chip_smoke.main).split("for phase in (")[1]
    loop = loop.split("):")[0]
    assert loop.index("phase_serving_tinyllama(") \
        < loop.index("phase_serving_d256(") \
        < loop.index("phase_training_d256(") < loop.index("phase_dit(")
    calls = inspect.getsource(chip_smoke.phase_kernels).split(
        "phase_bf16_head_dim_rows(")[1:]
    assert len(calls) == 2
    assert "wide=True" not in calls[0].split(")")[0]
    assert "wide=True" in calls[1].split(")")[0]


def test_bf16_d256_backward_entries():
    """K5 / K6 above head_dim 128 have ``/bf16_d256`` entries in the kernels
    line with their namesakes' source and reference kernel and ptxas tags
    of both 256-wide instances (without and with ids); phase 2 records
    their rows at every wide D, training_d256 sets their launches."""
    import inspect
    assert chip_smoke.BF16_D256_BWD == tuple(
        n + chip_smoke.BF16_D256 for n in chip_smoke.TRAIN_KERNELS)
    for name, base in zip(chip_smoke.BF16_D256_BWD, chip_smoke.TRAIN_KERNELS):
        assert chip_smoke.KERNEL_INFO[name] == chip_smoke.KERNEL_INFO[base]
        assert chip_smoke.KERNEL_INFO[name]["source"].endswith(
            "csrc/flash_attention_bwd.cu")
        tags = chip_smoke.BF16_D256_FUNCTIONS[base]
        assert len(tags) == 2 and all("wgmma_wide_kernel" in t
                                      for t in tags)
    rows_src = inspect.getsource(chip_smoke.phase_bf16_head_dim_rows)
    assert "k5_k6_rows(" in rows_src and "BF16_D256_BWD" in rows_src
    assert "bf16_d256_backward" not in inspect.getsource(chip_smoke)
    train_src = inspect.getsource(chip_smoke.phase_training_d256)
    assert "train_llama(" in train_src and "BF16_D256_BWD" in train_src
    assert 'kernels[entry]["launches"]' in inspect.getsource(
        chip_smoke.train_llama)


def test_training_rehearsed_on_the_cpu(monkeypatch):
    """Phase 5 end to end on the CPU with the Llama-3-8B config swapped for
    a narrow bf16 one (4 x 64 tokens): the gradient gate, the 8 steps and
    the tiny float32 model's card-vs-CPU steps run, and only the checks
    that need the card fail."""
    import paddle_tpu_torch.models as models
    failed = []

    def record(cond, what):
        if not cond:
            failed.append(what)

    monkeypatch.setattr(chip_smoke, "check", record)
    monkeypatch.setattr(models, "llama3_8b_config", lambda **kw: (
        models.tiny_llama_config(dtype="bfloat16", **kw)))
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    kernels = {n: {} for n in chip_smoke.TRAIN_KERNELS}
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    chip_smoke.phase_training(_TorchOnCpu(), kernels)
    assert [ln["phase"] for ln in lines] == [
        "training_grads", "training", "training_tiny_f32",
        "training_tiny_f32"]
    run = lines[1]
    assert run["layers"] == chip_smoke.TRAIN_LAYERS
    assert run["losses"][-1] < run["losses"][0]
    # the tiny model's steps count no K5 / K6 launch on the CPU either
    card_only = _CARD_ONLY + ("ran no backward kernel",)
    bad = [w for w in failed if not any(k in w for k in card_only)]
    assert not bad, bad
    assert failed, "the card-only checks cannot pass on the CPU"
    assert all("launches" in r for r in kernels.values())



# ---- float16 training: the /f16 backward rows and training_f16 -------------

@pytest.mark.parametrize("name,replaces", [
    ("flash_attention_bwd_dq/f16", "flash_attention.py:252"),
    ("flash_attention_bwd_dkv/f16", "flash_attention.py:299")])
def test_f16_backward_entries(name, replaces):
    """The float16 K5 / K6 have entries of their own (the bf16 backward's
    source and reference kernel), ptxas tags for every Hopper instance
    (both tile widths, with and without ids), phase 2's rows under them
    and training_f16's launches."""
    import inspect
    assert name in chip_smoke.F16_BWD
    info = chip_smoke.KERNEL_INFO[name]
    assert info["source"] == "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
    assert info["replaces"].endswith(replaces)
    tags = chip_smoke.F16_FUNCTIONS[name[:-len(chip_smoke.F16)]]
    assert len(tags) == 4 and any("_wide_" in t for t in tags)
    assert "F16_BWD" in inspect.getsource(
        chip_smoke.phase_bf16_head_dim_rows)
    assert "bwd_range_row(" in inspect.getsource(chip_smoke.phase_f16_rows)
    assert "zip(F16_BWD, TRAIN_KERNELS)" in inspect.getsource(
        chip_smoke.phase_training_f16)


def test_training_f16_phase_order_and_config():
    """training_f16 runs right after training_d256, at Llama-2-7B's widths
    cut to 8 of 32 layers, with a scale that overflows float16 for gate
    (d)."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    assert (src.index("phase_training_d256(")
            < src.index("phase_training_f16(")
            < src.index("phase_dit(torch"))
    assert chip_smoke.TRAIN_F16_LAYERS == 8
    assert chip_smoke.OVERFLOW_SCALE > 65504 * 2 ** 16


@pytest.mark.parametrize("seen", [
    [False] * 8, [True, True, False, False], [True] * 5,
    [False, True, False, True, True, False]])
def test_scaler_replay_is_the_update_rule(seen):
    """training_f16's replay of the scaler's states, in Python numbers,
    equals the port's ``GradScaler.update_state`` (itself held against
    JAX's in ``tests/test_torch_amp.py``)."""
    from paddle_tpu_torch import amp
    for kw in ({}, dict(incr_every_n_steps=2, decr_every_n_nan_or_inf=2)):
        s = amp.GradScaler(**kw)
        st, want = s.init_state(), []
        for f in seen:
            st = s.update_state(st, f)
            want.append((float(st["scale"]), int(st["good_steps"]),
                         int(st["bad_steps"])))
        assert chip_smoke.scaler_replay(seen, s) == want


def test_emit_resets_the_observability_layer(capsys):
    """A phase line closes a unit of work: the registry, tracer and
    request log are empty after it (no family nears its label cap over
    the script's hundreds of engines), and a line that is not a phase's
    leaves them as they are."""
    from paddle_tpu_torch import observability as obs

    obs.default_registry().counter("t.emit").inc()
    obs.get_request_log().event(obs.get_request_log().new_uid(), "x")
    chip_smoke.emit({"kernels": []})
    assert "t.emit" in obs.snapshot()
    chip_smoke.emit({"phase": "x"})
    assert "t.emit" not in obs.snapshot()
    assert not obs.get_request_log().records()
    assert not [e for e in obs.get_tracer().events()
                if e["name"] == "request.x"]
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["phase"] == "x"
