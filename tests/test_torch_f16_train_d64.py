"""The port's float16 train step with loss scaling against the JAX
package's ``build_train_step(..., scaler=)``, on the CPU, at the narrow
Llama of head_dim 64 with 8 query heads over one KV head: O2 through
``amp.decorate``, 4 steps from each of three scales
(``tests/torch_f16_train_parity.py``: the bars and why the optimizer is
Momentum; the tiny Llama is ``test_torch_f16_train.py``'s)."""

import pytest

from torch_f16_train_parity import (SCALES, check_losses, check_params,
                                    check_scaler_states, check_skips,
                                    jax_runs, port_run)

WIDTHS = dict(hidden_size=512, num_attention_heads=8, num_key_value_heads=1,
              intermediate_size=256, num_hidden_layers=2)


@pytest.fixture(scope="module")
def runs():
    init, jax_out = jax_runs(**WIDTHS)
    return init, {run: (jax_out[run], port_run(init, scale, **WIDTHS))
                  for run, scale in SCALES.items()}


@pytest.mark.parametrize("run", sorted(SCALES))
def test_f16_scaler_states_match_jax(runs, run):
    check_scaler_states(*runs[1][run])


@pytest.mark.parametrize("run", sorted(SCALES))
def test_f16_losses_match_jax(runs, run):
    check_losses(*runs[1][run])


@pytest.mark.parametrize("run", sorted(SCALES))
def test_f16_params_match_jax(runs, run):
    check_params(*runs[1][run])


@pytest.mark.parametrize("run", sorted(SCALES))
def test_f16_skipped_steps_leave_the_state(runs, run):
    """2^15 skips no step, 2^40 every step, the mixed run some but not
    all; each skipped step leaves the port's state bit-equal."""
    jax_out, port_out = runs[1][run]
    skipped = check_skips(jax_out, port_out, runs[0])
    n = len(jax_out)
    assert {"2^15": skipped == 0, "2^40": skipped == n,
            "mixed": 0 < skipped < n}[run], skipped
