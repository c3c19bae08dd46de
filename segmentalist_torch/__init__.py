"""segmentalist_torch: the PyTorch / CUDA port of segmentalist_tpu.

Imports torch and numpy only.  It ports the unigram and bigram segmenters
with the fixed-variance, diagonal- and full-covariance component families,
with hand-written Hopper kernels for candidate scoring, the segmentation
DP and the assignment chains (``ops/cuda_*.py``, ``csrc/``), the FBGMM's
own Gibbs sampler (its sequential sweep one kernel launch), and segmental
k-means (``KMeans``, ``SegmentalKMeansWordseg``: the DP kernel in its
Viterbi mode).  Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

from .corpus import Utterances
from .models import components_diag, components_fixedvar, components_full
from .models.bigram_lm import BigramSmoothLM
from .models.fbgmm import FBGMM
from .models.kmeans import KMeans
from .priors import NIW, FixedVarPrior
from .segmenters.bigram import BigramAcousticWordseg
from .segmenters.kmeans_seg import SegmentalKMeansWordseg
from .segmenters.unigram import UnigramAcousticWordseg

__all__ = ["BigramAcousticWordseg", "BigramSmoothLM", "FBGMM",
           "FixedVarPrior", "KMeans", "NIW", "SegmentalKMeansWordseg",
           "UnigramAcousticWordseg", "Utterances", "components_diag",
           "components_fixedvar", "components_full", "wishart"]


def __getattr__(name):
    # the Wishart samplers load on first use, as the JAX package's do
    # (segmentalist_tpu/__init__.py:43-46)
    if name == "wishart":
        import importlib

        return importlib.import_module(".wishart", __name__)
    raise AttributeError(name)
