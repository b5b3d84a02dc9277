"""``test_torch_f16_bwd.py``'s comparison at head_dim 256 (K5 / K6's
256-wide tiles at float16) and at the range shapes: the plain float16
backward against the Pallas kernel's VJP in interpret mode, 8 query
heads over one KV head with dead rows, packed documents, and dO near
3e2, V near 1e3, Q and K near 1e-2 at head dims 128 and 256."""

import pytest

from test_torch_f16_bwd import check_case

# (id, b, sq, skv, hq, hkv, d, causal, segments, range)
CASES = [
    ("d256_causal_gqa_dead_rows", 1, 256, 128, 8, 1, 256, True, None, False),
    ("d256_self_segments", 1, 128, 128, 8, 1, 256, True, "self", False),
    ("d256_range", 1, 128, 128, 4, 4, 256, True, None, True),
    ("d128_range", 1, 128, 128, 4, 4, 128, True, None, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_f16_bwd_d256_reference_matches_pallas_interpret(case):
    check_case(case)
