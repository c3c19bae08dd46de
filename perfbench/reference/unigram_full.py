"""Reference of the unigram driver with full-covariance NIW components
(kernels K8, K2 and K9 in the program, the FBGMM's item chain K11 with
``am_n_iter``).  The math is in :mod:`.unigram` and :mod:`.families`;
this file names the stage functions whose inputs and outputs the
benchmark captures for the judge."""

from .unigram import control, judge  # noqa: F401

CAPTURE = {
    "dp": "segmentalist_torch.segmenters.blocked:segment_dp",
    "chain": "segmentalist_torch.segmenters.blocked:fullcov_chain",
}
