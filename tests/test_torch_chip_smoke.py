"""Host-side helpers of ``chip_smoke.py`` (the port's check on the card),
on the CPU: the ptxas-log guard against serialised ``wgmma`` and the
visible-pair rule its contract rows hold the kernels to."""

import importlib.util
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
