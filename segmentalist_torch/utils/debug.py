"""Observability and opt-in validation for the samplers.

Counterpart of ``segmentalist_tpu/utils/debug.py``, the reference's two
debug mechanisms:

* ``i_debug_monitor`` traces (``unigram_acoustic_wordseg.py:19-20,
  :262-307``; ``bigram_acoustic_wordseg.py:24, :400-407``): pass
  ``monitor_i=<utterance index>`` to ``gibbs_sample`` / ``segment`` and
  the driver logs, after every sweep, that utterance's candidate scores,
  boundaries and transcript at DEBUG level.  The scores are the
  leave-one-utterance-out scores a sweep samples from, computed after the
  sweep.

* NaN guards on the sampling distributions (``fbgmm.py:453``,
  ``unigram_acoustic_wordseg.py:717-754``, ``bigram_acoustic_wordseg.py:
  368``): pass ``validate=True`` and every sweep computes the invariant
  flags below on the device (all statistics finite, counts non-negative
  and consistent with the assignment vector, every utterance's final
  boundary set).  They are fetched after the last sweep, and the first
  violation raises :class:`ValidationError`, naming the sweep and the
  invariant.
"""

from __future__ import annotations

import logging

import numpy as np
import torch


class ValidationError(AssertionError):
    """A sampler invariant was violated (see ``validate=True``)."""


FBGMM_CHECKS = (
    "non-finite component sum_x",
    "non-finite component sum_sq",
    "negative component count",
    "count/assignment-vector mismatch",
    "missing final utterance boundary",
)
BIGRAM_CHECKS = FBGMM_CHECKS + ("negative LM count",)
KMEANS_CHECKS = (
    "non-finite component sum_x",
    "negative component count",
    "count/assignment-vector mismatch",
    "missing final utterance boundary",
)


def _final_boundaries_set(boundaries: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Every utterance of positive length has its last boundary set."""
    rows = torch.arange(boundaries.shape[0], device=boundaries.device)
    last = boundaries[rows, (lengths - 1).clamp_min(0).long()]
    return (last | (lengths <= 0)).all()


def fbgmm_validation_flags(stats, assignments: torch.Tensor,
                           boundaries: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """[5] bool tensor of the invariants of ``FBGMM_CHECKS`` (True = OK),
    on the state's device."""
    return torch.stack([
        torch.isfinite(stats.sum_x).all(),
        torch.isfinite(stats.sum_sq).all(),
        (stats.counts >= 0).all(),
        stats.counts.sum() == (assignments >= 0).sum(),
        _final_boundaries_set(boundaries, lengths),
    ])


def bigram_validation_flags(stats, assignments: torch.Tensor,
                            boundaries: torch.Tensor, lengths: torch.Tensor,
                            lm_state) -> torch.Tensor:
    """[6] bool tensor of ``BIGRAM_CHECKS``: the FBGMM's and the LM
    tables' counts non-negative."""
    lm_ok = ((lm_state.unigram_counts >= 0).all()
             & (lm_state.bigram_counts >= 0).all())
    return torch.cat([
        fbgmm_validation_flags(stats, assignments, boundaries, lengths),
        lm_ok[None],
    ])


def kmeans_validation_flags(state, boundaries: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """[4] bool tensor of ``KMEANS_CHECKS`` of a ``KMeansState``."""
    return torch.stack([
        torch.isfinite(state.sum_x).all(),
        (state.counts >= 0).all(),
        state.counts.sum() == (state.assignments >= 0).sum(),
        _final_boundaries_set(boundaries, lengths),
    ])


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def check_validation(fetched_flags, check_names):
    """Raise ValidationError naming the first violated invariant;
    ``fetched_flags`` holds a flag vector a sweep."""
    for i_iter, flags in enumerate(fetched_flags):
        flags = _host(flags)
        if not flags.all():
            bad = [n for n, ok in zip(check_names, flags) if not ok]
            raise ValidationError(
                "sampler invariant violated at iteration %d: %s"
                % (i_iter, ", ".join(bad))
            )


def log_monitor(logger: logging.Logger, monitor_i: int, fetched):
    """DEBUG-log one monitored utterance's trace, two lines a sweep, from
    its ``(scores, boundaries, transcript)`` a sweep."""
    for i_iter, (scores, bounds, transcript) in enumerate(fetched):
        scores = _host(scores)
        transcript = _host(transcript)
        logger.debug(
            "monitor utterance %d, iteration %d: boundaries=%s, "
            "transcript=%s",
            monitor_i, i_iter,
            _host(bounds).astype(int).tolist(),
            transcript[transcript >= -1].tolist(),
        )
        logger.debug(
            "monitor utterance %d, iteration %d: candidate scores "
            "(end x width, -inf masked):\n%s",
            monitor_i, i_iter, np.array2string(scores, precision=3),
        )
