"""Faults planted underneath the timed path, which the check has to
catch: each function takes a ``monkeypatch`` (``pytest.MonkeyPatch``) and
breaks one step of the program where it is produced.  The CPU tests run
each on the tiny cells; ``control.py --fault <name>`` reads one at a
cell's own size on the card."""

import numpy as np
import torch


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the merge writes
    nothing."""
    from segmentalist_torch.segmenters import blocked

    def merge(self, blk, new_bounds, new_embeds, Xe_new, new_ks, log_prob,
              lm_delta=None):
        return torch.where(blk.valid, log_prob, 0.0).sum(), []

    monkeypatch.setattr(blocked.BlockedWordseg, "_merge", merge)


def _half_batch(monkeypatch):
    """Half of each block left out: its utterances are never resampled."""
    from segmentalist_torch.segmenters import unigram

    inner = unigram.UnigramAcousticWordseg.block_step

    def step(self, idx_blk, *a, **k):
        idx = np.array(idx_blk)
        idx[len(idx) // 2:] = -1
        return inner(self, idx, *a, **k)

    monkeypatch.setattr(unigram.UnigramAcousticWordseg, "block_step", step)


def _chain_altered(monkeypatch):
    """A draw altered where the chain produces it: the first segment of
    a block's first utterance takes the component that another
    utterance's first segment drew."""
    from segmentalist_torch.segmenters import blocked, unigram

    def alter(fn):
        def chain(*a, **k):
            ks = fn(*a, **k).clone()
            other = ks[1:, 0][(ks[1:, 0] >= 0) & (ks[1:, 0] != ks[0, 0])]
            ks[0, 0] = other[0] if len(other) else (ks[0, 0] + 1) % 12
            return ks
        return chain

    monkeypatch.setattr(unigram, "fixedvar_chain",
                        alter(unigram.fixedvar_chain))
    monkeypatch.setattr(blocked, "fullcov_chain",
                        alter(blocked.fullcov_chain))


def _boundary_altered(monkeypatch):
    """A boundary altered where the DP produces it."""
    from segmentalist_torch.segmenters import blocked

    inner = blocked.segment_dp

    def dp(*a, **k):
        lp, b = inner(*a, **k)
        b = b.clone()
        b[0, 0] = ~b[0, 0]
        return lp, b

    monkeypatch.setattr(blocked, "segment_dp", dp)


def _scores_altered(monkeypatch):
    """Candidate scores half as large again where the scorer makes
    them."""
    from segmentalist_torch.segmenters import blocked

    for name in ("fixedvar_log_margs_T", "fullcov_log_margs"):
        inner = getattr(blocked, name)
        monkeypatch.setattr(blocked, name,
                            lambda *a, _f=inner, **k: _f(*a, **k) * 1.5)


def _items_altered(monkeypatch):
    """The acoustic model's sequential draws altered where they are made:
    each item drawn on its noise row scaled thirtyfold, as from a far
    hotter conditional (the program stays consistent with itself, so only
    the reference can see it)."""
    from segmentalist_torch.models import fbgmm

    inner = fbgmm.item_chain

    def chain(family, X, log_prior, noise, *a, **k):
        return inner(family, X, log_prior, 30.0 * noise, *a, **k)

    monkeypatch.setattr(fbgmm, "item_chain", chain)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "chain_altered": _chain_altered,
          "boundary_altered": _boundary_altered,
          "scores_altered": _scores_altered, "items_altered": _items_altered}
