"""The bigram move's oracle in the full family, on the port's own noise:
``tests/test_torch_exact_posterior_bigram_diag.py``'s case with the NIW
predictive density of ``tests/test_torch_exact_posterior_bigram_fullcov.py``
(a file of its own, to keep each file's moves within a worker's budget).
On a card (``chip_smoke.py``, :data:`CARD_CASES`) the move runs K8, K2 and
K9's bigram mode.
"""

from test_torch_exact_posterior_bigram_diag import (
    _jax_segmenter, card_case, family_case, family_segmenter)
from torch_oracle import anchor

CARD_CASES = {"bigram_full": card_case("full")}


def test_bigram_full_single_move_transition_kernel():
    jseg, emb0 = _jax_segmenter("full")
    seg, _ = family_segmenter("full")
    family_case("full", anchor(seg, jseg), emb0)
