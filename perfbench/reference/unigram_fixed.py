"""Reference of the unigram driver with fixed-variance components (the
papers' model: kernels K1, K2 and K3 in the program).  The math is in
:mod:`.unigram` and :mod:`.families`; this file names what the benchmark
captures from the program for the judge: the stage functions whose
inputs and outputs are read, as ``module:attribute`` strings."""

from .unigram import control, judge  # noqa: F401

CAPTURE = {
    # the DP: its input scores (the scorer's output, duration-scaled and
    # masked) and its draw
    "dp": "segmentalist_torch.segmenters.blocked:segment_dp",
    # the chains' draws, before the cross-utterance decollision
    "chain": "segmentalist_torch.segmenters.unigram:fixedvar_chain",
}
