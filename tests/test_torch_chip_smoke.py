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

from paddle_tpu_torch.ops.attention import _keep_mask

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
    assert "DIT_BWD" in rows_src and "backward_rows(" in rows_src


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
