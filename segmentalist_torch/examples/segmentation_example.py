"""End-to-end word segmentation on a synthetic acoustic-word-embedding
corpus.

Counterpart of the JAX package's ``examples/segmentation_example.py`` (and
the reference module demos, unigram_acoustic_wordseg.py:871-963,
kmeans_acoustic_wordseg.py, bigram_acoustic_wordseg.py:765-857): build a
corpus of utterances with known word boundaries, run each of the three
segmenters, and report boundary precision, recall and F1 and the
discovered clusters.

    python -m segmentalist_torch.examples.segmentation_example              # the card
    python -m segmentalist_torch.examples.segmentation_example --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from segmentalist_torch import (BigramAcousticWordseg, FBGMM, FixedVarPrior,
                                SegmentalKMeansWordseg,
                                UnigramAcousticWordseg)
from segmentalist_torch.utils.synth import boundary_f_score, synthetic_corpus


def main(device="cuda"):
    """Run the three segmenters on the card (or ``device``); returns each
    one's boundary F1."""
    em, vi, du, lm, truth = synthetic_corpus(
        n_utterances=60, n_landmarks_max=10, D=8, K_true=6, n_slices_max=4,
        seed=0)
    # float32, the kernels' type
    em = {k: v.astype(np.float32) for k, v in em.items()}
    D = 8
    prior = FixedVarPrior.create(0.05 * np.ones(D, np.float32),
                                 np.zeros(D, np.float32),
                                 np.ones(D, np.float32))
    f1s = {}

    def report(name, seg, rec_key, rec):
        pred = {u: seg.utterances.boundaries[i]
                for i, u in enumerate(seg.ids_to_utterance_labels)}
        p, r, f1 = boundary_f_score(pred, truth)
        f1s[name] = f1
        print("%-22s P=%.3f R=%.3f F1=%.3f   %s=%.1f" % (
            name, p, r, f1, rec_key, rec[rec_key][-1]))
        print("  utt0 transcript:",
              [int(k) for k in seg.get_unsup_transcript_i(0)])

    common = dict(embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                  landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=4,
                  batch_size=20, seed=0, device=device)
    seg = UnigramAcousticWordseg(FBGMM, am_alpha=1.0, am_K=30,
                                 am_param_prior=prior, beta_sent_boundary=-1,
                                 **common)
    report("unigram FBGMM", seg, "log_marg", seg.gibbs_sample(15))

    km = SegmentalKMeansWordseg(am_K=30, **common)
    report("segmental k-means", km, "sum_neg_sqrd_norm", km.segment(15))

    bi = BigramAcousticWordseg(
        am_K=30, am_param_prior=prior,
        lm_params={"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0},
        beta_sent_boundary=-1, fb_type="unigram", **common)
    report("bigram FBGMM", bi, "log_marg", bi.gibbs_sample(15))
    return f1s


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
