"""Bigram-tied finite Bayesian GMM (counterpart of
``segmentalist_tpu/models/bigram_fbgmm.py``; reference ``BigramFBGMM``,
``bigram_fbgmm.py:19-100``): an :class:`FBGMM` with no Dirichlet ``alpha``
and no Gibbs sampler of its own.  The mixture weights come from the bigram
language model and assignment sampling lives in the bigram segmenter.
Slots are never relabelled, so the LM needs no tie into the component
store; ``lm`` is kept for signature parity.
"""

from __future__ import annotations

from .fbgmm import FBGMM


class BigramFBGMM(FBGMM):
    def __init__(self, X, prior, K, assignments="rand",
                 covariance_type="fixed", lms=1.0, lm=None, seed=0,
                 device="cuda"):
        # alpha is unused by the bigram model (weights come from the LM); the
        # value 0 makes accidental use of the Dirichlet path conspicuous.
        super().__init__(X, prior, alpha=0.0, K=K, assignments=assignments,
                         covariance_type=covariance_type, lms=lms, seed=seed,
                         device=device)
        self.lm = lm

    def gibbs_sample(self, *args, **kwargs):
        raise NotImplementedError(
            "BigramFBGMM has no own Gibbs sampler; assignment sampling is "
            "driven by BigramAcousticWordseg (reference bigram_fbgmm.py has "
            "no gibbs_sample either)")
