"""The port's 32-round fused steady_round against JAX's Pallas kernel in
interpret mode (the main path's k), at P=3 and P=5.  Split from
test_torch_fused.py because each k=32 interpret-mode build takes seconds:
in its own file it runs on its own test worker."""

import pytest

from test_torch_fused import check_steady_round


@pytest.mark.parametrize("P", [3, 5])
def test_steady_round_k32_matches_pallas(P):
    check_steady_round(P, 32, "settled")
