"""Faults of the bigram driver, planted underneath the timed path as
``faults.py`` plants its own: each function takes a ``monkeypatch``
(``pytest.MonkeyPatch``) and breaks one step of the program where it is
produced.  The CPU tests run each on the tiny bigram cell; at a cell's own
size on the card

    python3 perfbench/faults_bigram.py --workload <cell> --seconds <s> --seeds <n,n,...> --fault <name>

reads one (the faults of ``faults.py`` and ``faults_items.py`` by their
names too), as ``control.py --fault`` does: one JSON line a seed."""

import os
import sys

import torch


def _bigram_chain_altered(monkeypatch):
    """A draw altered where the bigram chain (K4) produces it: the first
    segment of a block's first utterance takes the component that another
    utterance's first segment drew (``faults.py``'s ``chain_altered`` for
    K4)."""
    from segmentalist_torch.segmenters import bigram

    inner = bigram.bigram_fixedvar_chain

    def chain(*a, **k):
        ks = inner(*a, **k).clone()
        other = ks[1:, 0][(ks[1:, 0] >= 0) & (ks[1:, 0] != ks[0, 0])]
        ks[0, 0] = other[0] if len(other) else (ks[0, 0] + 1) % 12
        return ks

    monkeypatch.setattr(bigram, "bigram_fixedvar_chain", chain)


def _bigram_unchanged(monkeypatch):
    """A step that returns its state unchanged: the merge writes nothing
    and the LM's delta is zero (``faults.py``'s ``unchanged``, whose merge
    returns no LM delta, makes the bigram step raise instead)."""
    from segmentalist_torch.segmenters import blocked

    def merge(self, blk, new_bounds, new_embeds, Xe_new, new_ks, log_prob,
              lm_delta=None):
        lp = torch.where(blk.valid, log_prob, 0.0).sum()
        if lm_delta is None:
            return lp, []
        return lp, [torch.zeros_like(t) for t in self.lm.state]

    monkeypatch.setattr(blocked.BlockedWordseg, "_merge", merge)


def _replay_altered(monkeypatch):
    """The corpus log P(z) of the record replayed without its bigram term
    (``intrp_lambda`` 1: the unigram LM's replay)."""
    from segmentalist_torch.segmenters import bigram

    inner = bigram.log_prob_z_replay

    def replay(transcripts, intrp_lambda, *a, **k):
        return inner(transcripts, 1.0, *a, **k)

    monkeypatch.setattr(bigram, "log_prob_z_replay", replay)


def _lm_stale(monkeypatch):
    """The LM's count tables left as they were after every block: the
    acoustic merge writes the new segments, the LM never counts them."""
    from segmentalist_torch.segmenters import bigram

    monkeypatch.setattr(bigram, "apply_delta", lambda state, delta: state)


FAULTS = {"bigram_chain_altered": _bigram_chain_altered,
          "bigram_unchanged": _bigram_unchanged,
          "replay_altered": _replay_altered, "lm_stale": _lm_stale}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    from perfbench import control, faults, faults_items

    faults.FAULTS.update(FAULTS, **faults_items.FAULTS)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
