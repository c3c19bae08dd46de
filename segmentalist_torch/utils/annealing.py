"""Simulated-annealing temperature schedules.

Host-side transcription of the reference's annealing iterators
(``fbgmm.py:332-348``, ``unigram_acoustic_wordseg.py:404-421``): the schedule
is materialised up-front as a [n_iter] vector of temperatures, one per sweep.

Reference quirk, reproduced exactly: once a schedule's list is exhausted the
reference's ``next(get_anneal_temp, anneal_end_temp_inv)`` falls back to the
*inverse* temperature value itself (``fbgmm.py:354``); for the usual
``anneal_end_temp_inv = 1`` this is indistinguishable from temperature 1.
"""

from __future__ import annotations

import numpy as np


def anneal_temperatures(
    n_iter: int,
    anneal_schedule=None,
    anneal_start_temp_inv: float = 0.1,
    anneal_end_temp_inv: float = 1.0,
    n_anneal_steps: int = -1,
) -> np.ndarray:
    """Return the [n_iter] vector of per-sweep temperatures."""
    default = float(anneal_end_temp_inv)
    if anneal_schedule is None:
        temps = []
    elif anneal_schedule == "linear":
        if n_anneal_steps == -1:
            n_anneal_steps = n_iter
        temps = list(
            1.0 / np.linspace(anneal_start_temp_inv, anneal_end_temp_inv, n_anneal_steps)
        )
    elif anneal_schedule == "step":
        if n_anneal_steps == -1:
            raise ValueError("`n_anneal_steps` of -1 not allowed for step "
                             "annealing schedule")
        n_iter_per_step = int(round(float(n_iter) / n_anneal_steps))
        anneal_list = 1.0 / np.linspace(
            anneal_start_temp_inv, anneal_end_temp_inv, n_anneal_steps
        )
        temps = list(np.repeat(anneal_list, n_iter_per_step))
    else:
        raise ValueError("invalid anneal_schedule: %r" % (anneal_schedule,))

    out = np.full((n_iter,), default, dtype=np.float64)
    m = min(len(temps), n_iter)
    out[:m] = temps[:m]
    return out
