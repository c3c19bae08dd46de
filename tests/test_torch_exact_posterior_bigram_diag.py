"""The bigram move's oracle in the diag family, on the port's own noise
(the full family's is ``tests/test_torch_exact_posterior_bigram_full.py``,
on this file's helpers).

``tests/test_torch_exact_posterior_bigram_fullcov.py``'s enumeration (the
LM leave-out and own-pair corrections) composed with the diag and full
predictive densities of the unigram oracles
(``tests/test_torch_exact_posterior_diag.py``,
``..._bigram_fullcov.py``), on the bigram oracle's layout (utterance 0 of
3 landmarks, utterance 1 of 2) with D 2 embeddings.  The JAX package has
no such test; the state is still the JAX segmenter's, built from the same
arguments and carried across by ``interop.load_state``.  On a card
(``chip_smoke.py``, :data:`CARD_CASES`) the move runs K5, K2 and K7.
"""

import numpy as np

from test_torch_exact_posterior_bigram_fullcov import (
    LM_PARAMS, bigram_case, bigram_segmenter, niw_pred, niw_prior)
from test_torch_exact_posterior_diag import diag_pred, diag_prior
from torch_oracle import anchor

FAMILIES = {"diag": (diag_prior, diag_pred), "full": (niw_prior, niw_pred)}


def _embeddings():
    rng = np.random.RandomState(31)
    return rng.randn(6, 2) * 1.1, rng.randn(3, 2) * 0.9


def family_segmenter(cov, device="cpu"):
    """The bigram oracle's segmenter with ``cov`` ("diag" or "full")
    components: the unigram oracles' NIW priors, D 2."""
    return bigram_segmenter(device, FAMILIES[cov][0](device), _embeddings(),
                            cov)


def family_case(cov, seg, emb0) -> dict:
    return bigram_case(seg, emb0, FAMILIES[cov][1], full=cov == "full")


def card_case(cov):
    return lambda dev: family_case(cov, *family_segmenter(cov, dev))


CARD_CASES = {"bigram_diag": card_case("diag")}


def _jax_segmenter(cov):
    """The JAX bigram segmenter from the arguments of
    :func:`family_segmenter`."""
    from segmentalist_tpu import NIW
    from segmentalist_tpu.segmenters.bigram import BigramAcousticWordseg

    prior = NIW.create(*(t.numpy() for t in FAMILIES[cov][0]("cpu")))
    emb0, emb1 = _embeddings()
    np.random.seed(11)  # the JAX init draws from numpy's global RNG
    return BigramAcousticWordseg(
        am_K=2, am_param_prior=prior, lm_params=LM_PARAMS,
        embedding_mats={"u0": emb0, "u1": emb1},
        vec_ids_dict={"u0": np.arange(6), "u1": np.arange(3)},
        durations_dict={"u0": [1, 2, 1, 3, 2, 1], "u1": [1, 2, 1]},
        landmarks_dict={"u0": [1, 2, 3], "u1": [1, 2]},
        covariance_type=cov, p_boundary_init=0.5, beta_sent_boundary=-1,
        n_slices_max=3, time_power_term=0.0, wip=0.0, batch_size=1, seed=11,
        fb_type="unigram"), emb0


def test_bigram_diag_single_move_transition_kernel():
    jseg, emb0 = _jax_segmenter("diag")
    seg, _ = family_segmenter("diag")
    family_case("diag", anchor(seg, jseg), emb0)
