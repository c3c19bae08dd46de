"""Reference of the bigram driver with fixed-variance components (kernels
K1, K2 and K4 in the program, with the bigram LM's count tables).  The
math is in :mod:`.bigram`, :mod:`.unigram` and :mod:`.families`; this file
names what the benchmark captures from the program for the judge: the
stage functions whose inputs and outputs are read, as
``module:attribute`` strings."""

from .bigram import control, judge  # noqa: F401

CAPTURE = {
    # the DP: its input scores (the scorer's output under the LM's
    # leave-out unigram weights, duration-scaled and masked) and its draw
    "dp": "segmentalist_torch.segmenters.blocked:segment_dp",
    # the bigram chains' draws, before the cross-utterance decollision
    "chain": "segmentalist_torch.segmenters.bigram:bigram_fixedvar_chain",
}
