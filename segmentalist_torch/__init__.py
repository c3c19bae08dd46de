"""segmentalist_torch: the PyTorch / CUDA port of segmentalist_tpu.

Imports torch and numpy only.  The first slice ports the fixed-variance
unigram segmenter with hand-written Hopper kernels for candidate scoring,
the DP forward filter and the assignment chain (``ops/cuda_*.py``,
``csrc/``).
"""

from .corpus import Utterances
from .models.fbgmm import FBGMM
from .priors import NIW, FixedVarPrior
from .segmenters.unigram import UnigramAcousticWordseg

__all__ = ["FBGMM", "FixedVarPrior", "NIW", "UnigramAcousticWordseg",
           "Utterances"]
