"""The port's DDIM timesteps against the JAX package's, on the CPU.

The reference samples at ``jnp.linspace(T - 1, 0, steps).round()``
(``paddle_tpu/models/diffusion.py:54-55``); a point of that float32
linspace that lands near a half decides its timestep by its last bits.
``paddle_tpu_torch.models.diffusion._linspace_f32`` reproduces XLA's CPU
build of ``linspace`` bit for bit: the folded-constant form below 353
points, and from 353 on the vectorized loop's fused ``1 - i * r`` (8
float32 lanes, 4 unrolled) with the folded form in the remainder.  That
loop shape is the host's: it was read from XLA's LLVM IR and object code
on an x86-64 Intel Xeon with FMA and AVX-512 (jaxlib 0.9.0, LLVM's
``prefer-vector-width`` 256).  A host whose code generator picks another
vector width, or no FMA, builds another loop, and these tests would then
show it.

The tier-1 test checks the 128 step counts at which an earlier form of the
port differed (T = 1000) and every 25th count; the full sweep of 1..1000
compiles JAX's ``linspace`` once per length (about 0.07-0.17 s each), so
it is marked ``slow``."""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.models import diffusion as jdiff

from paddle_tpu_torch.models import ddim_timesteps, diffusion_schedule
from paddle_tpu_torch.models.diffusion import _linspace_f32

T = 1000

# the step counts at which the port's timesteps once differed from JAX's
# (by 1-5 timesteps each, at T = 1000)
ONCE_DIFFERED = (
    355, 363, 367, 371, 373, 379, 381, 391, 397, 403, 409, 415, 417, 421,
    423, 433, 439, 443, 445, 447, 449, 457, 463, 469, 475, 477, 481, 483,
    487, 493, 499, 501, 505, 507, 511, 517, 519, 523, 535, 541, 547, 559,
    565, 577, 579, 589, 593, 595, 607, 613, 619, 631, 637, 643, 649, 655,
    661, 667, 669, 679, 685, 687, 691, 697, 699, 703, 709, 725, 733, 739,
    741, 745, 747, 751, 757, 759, 761, 763, 781, 787, 793, 799, 803, 805,
    811, 815, 817, 819, 823, 827, 829, 833, 839, 841, 843, 845, 847, 865,
    871, 877, 879, 883, 885, 889, 893, 895, 897, 907, 911, 913, 919, 925,
    937, 943, 949, 953, 955, 961, 963, 965, 971, 973, 975, 979, 983, 985,
    991, 997)


def _jax_ts(steps: int) -> list:
    return np.asarray(jnp.linspace(T - 1, 0, steps).round()
                      .astype(jnp.int32)).tolist()


def _mismatches(counts) -> list:
    return [n for n in counts if ddim_timesteps(n, T).tolist() != _jax_ts(n)]


def test_once_differing_counts_are_listed_in_full():
    assert len(ONCE_DIFFERED) == 128 and len(set(ONCE_DIFFERED)) == 128


def test_ddim_timesteps_match_jax_where_they_once_differed():
    assert _mismatches(ONCE_DIFFERED) == []


def test_ddim_timesteps_match_jax_every_25th_count():
    assert _mismatches(range(1, T + 1, 25)) == []


@pytest.mark.parametrize("num", [2, 100, 352, 353, 355, 385, 999, 1000])
def test_linspace_bits_match_jax(num):
    """Every float32 point bit for bit, on either side of the loop form's
    threshold and with remainders of 0-31 points."""
    want = np.asarray(jnp.linspace(T - 1, 0, num))
    got = _linspace_f32(T - 1, 0, num).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


def test_schedule_betas_bitwise_and_alpha_bar_within_rtol():
    """The betas (1000 points: the loop form, stop != 0) bit for bit; the
    cumulative alpha-bar at rtol 1e-6 (the products' order may differ)."""
    want = np.asarray(jnp.linspace(1e-4, 0.02, T, dtype=jnp.float32))
    got = _linspace_f32(1e-4, 0.02, T).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    np.testing.assert_allclose(diffusion_schedule().numpy(),
                               np.asarray(jdiff.diffusion_schedule()),
                               rtol=1e-6, atol=0)


@pytest.mark.slow
def test_ddim_timesteps_match_jax_at_every_count():
    """All of 1..1000 (about 70-170 s: one JAX compile a length)."""
    assert _mismatches(range(1, T + 1)) == []
