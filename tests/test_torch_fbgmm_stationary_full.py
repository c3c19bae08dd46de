"""The FBGMM's sequential stationary distribution in the full family (K11
on a card), on the port's own noise: ``tests/test_torch_fbgmm_stationary.py``'s
case, in a file of its own to keep each file within a worker's budget."""

from test_torch_fbgmm_stationary import anchored_model, stationary_case


def test_full_sequential_stationary_distribution():
    stationary_case("full", anchored_model("full"))
