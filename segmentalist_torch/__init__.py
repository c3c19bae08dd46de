"""segmentalist_torch: the PyTorch / CUDA port of segmentalist_tpu.

Imports torch and numpy only.  It ports the unigram and bigram segmenters
with the fixed-variance, diagonal- and full-covariance component families,
with hand-written Hopper kernels for candidate scoring, the segmentation
DP and the assignment chains (``ops/cuda_*.py``, ``csrc/``), and the
FBGMM's own Gibbs sampler (its sequential sweep one kernel launch).  Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .corpus import Utterances
from .models import components_diag, components_fixedvar, components_full
from .models.bigram_lm import BigramSmoothLM
from .models.fbgmm import FBGMM
from .priors import NIW, FixedVarPrior
from .segmenters.bigram import BigramAcousticWordseg
from .segmenters.unigram import UnigramAcousticWordseg

__all__ = ["BigramAcousticWordseg", "BigramSmoothLM", "FBGMM",
           "FixedVarPrior", "NIW", "UnigramAcousticWordseg", "Utterances",
           "components_diag", "components_fixedvar", "components_full",
           "wishart"]


def __getattr__(name):
    # the Wishart samplers load on first use, as the JAX package's do
    # (segmentalist_tpu/__init__.py:43-46)
    if name == "wishart":
        import importlib

        return importlib.import_module(".wishart", __name__)
    raise AttributeError(name)
