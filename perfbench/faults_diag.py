"""Faults of the diagonal-covariance family, planted underneath the timed
path as ``faults.py`` plants its own: each function takes a
``monkeypatch`` (``pytest.MonkeyPatch``) and breaks one step of the
program where it is produced.  The CPU tests run each on a tiny diag cell;
at a cell's own size on the card

    python3 perfbench/faults_diag.py --workload <cell> --seconds <s> --seeds <n,n,...> --fault <name>

reads one (the faults of ``faults.py`` by their names too), as
``control.py --fault`` does: one JSON line a seed."""

import os
import sys

import torch


def _diag_scores_altered(monkeypatch):
    """Candidate scores half as large again where the diag scorer (K5)
    makes them."""
    from segmentalist_torch.segmenters import blocked

    inner = blocked.diag_log_margs_T
    monkeypatch.setattr(blocked, "diag_log_margs_T",
                        lambda *a, **k: inner(*a, **k) * 1.5)


def _diag_chain_altered(monkeypatch):
    """A draw altered where the diag chain (K6) produces it: the first
    segment of a block's first utterance takes the component that another
    utterance's first segment drew (``faults.py``'s ``chain_altered`` for
    K6)."""
    from segmentalist_torch.segmenters import unigram

    inner = unigram.diag_chain

    def chain(*a, **k):
        ks = inner(*a, **k).clone()
        other = ks[1:, 0][(ks[1:, 0] >= 0) & (ks[1:, 0] != ks[0, 0])]
        ks[0, 0] = other[0] if len(other) else (ks[0, 0] + 1) % 12
        return ks

    monkeypatch.setattr(unigram, "diag_chain", chain)


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _diag_tables_bf16(monkeypatch):
    """The diag family's tables in bfloat16, the precision below the
    configuration's float32: the predictive ``muT`` / ``inv_varT`` rounded
    through it before K5, the leave-out sums ``sum_xT`` / ``sum_sqT``
    before K6."""
    from segmentalist_torch.segmenters import blocked, unigram

    score = blocked.diag_log_margs_T

    def scores(Xc, prior_c, muT, inv_varT, *a, **k):
        return score(Xc, prior_c, _bf16(muT), _bf16(inv_varT), *a, **k)

    chain = unigram.diag_chain

    def chains(embeds, Xe, lpe, noise, counts, sum_xT, sum_sqT, *a, **k):
        return chain(embeds, Xe, lpe, noise, counts, _bf16(sum_xT),
                     _bf16(sum_sqT), *a, **k)

    monkeypatch.setattr(blocked, "diag_log_margs_T", scores)
    monkeypatch.setattr(unigram, "diag_chain", chains)


FAULTS = {"diag_scores_altered": _diag_scores_altered,
          "diag_chain_altered": _diag_chain_altered,
          "diag_tables_bf16": _diag_tables_bf16}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    from perfbench import control, faults

    faults.FAULTS.update(FAULTS)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
