"""The reference public-API surface on the port's classes: the names of
tests/test_api_surface.py's ``SURFACE`` lists for the classes the port has
(``FBGMM``, ``Utterances``, ``UnigramAcousticWordseg`` and the component
view) respond on the port's objects, and the per-utterance calls run."""

import numpy as np
import pytest

import segmentalist_torch as pt
from segmentalist_torch.utils.synth import synthetic_corpus

SURFACE = {
    "FBGMM": (
        "setup_components set_K log_prob_z log_prob_X_given_z log_marg "
        "log_marg_i gibbs_sample gibbs_sample_inside_loop_i map_assign_i "
        "get_n_assigned alpha covariance_type lms prior components"
    ),
    "Utterances": (
        "get_segmented_embeds_i get_segmented_durations_i "
        "get_original_segmented_embeds_i get_segmented_landmark_indices "
        "get_segmented_landmarks boundaries durations landmarks lengths "
        "vec_ids"
    ),
    "UnigramAcousticWordseg": (
        "set_fb_type gibbs_sample_i gibbs_sample get_vec_embed_log_probs "
        "calc_p_continue get_unsup_transcript_i get_log_margs_i "
        "beta_sent_boundary fb_type ids_to_utterance_labels n_slices_max "
        "n_slices_min time_power_term utterances wip"
    ),
    "ComponentsView": (
        "add_item del_item del_component log_prior log_post_pred_k "
        "log_post_pred log_marg_k log_marg rand_k map counts prior "
        "get_assignments assignments"
    ),
}


@pytest.fixture(scope="module")
def objs():
    D = 4
    em, vi, du, lm, _ = synthetic_corpus(
        n_utterances=6, n_landmarks_max=6, D=D, K_true=3, n_slices_max=3,
        seed=0)
    em = {k: v.astype(np.float32) for k, v in em.items()}
    prior = pt.FixedVarPrior.create(0.1 * np.ones(D, np.float32),
                                    np.zeros(D, np.float32),
                                    np.ones(D, np.float32))
    X = np.random.RandomState(0).randn(20, D).astype(np.float32)
    np.random.seed(0)
    fb = pt.FBGMM(X, prior, 1.0, 8, "rand", covariance_type="fixed",
                  device="cpu")
    useg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=1.0, am_K=8, am_param_prior=prior,
        embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
        landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=3,
        batch_size=2, seed=0, device="cpu")
    return {"FBGMM": fb, "Utterances": useg.utterances,
            "UnigramAcousticWordseg": useg, "ComponentsView": fb.components}


@pytest.mark.parametrize("cls", sorted(SURFACE))
def test_reference_surface_present(objs, cls):
    obj = objs[cls]
    missing = [n for n in SURFACE[cls].split() if not hasattr(obj, n)]
    assert not missing, "%s missing reference names: %s" % (cls, missing)


def test_components_view_prior_is_model_prior(objs):
    fb = objs["FBGMM"]
    assert fb.components.prior is fb.prior


def test_utterance_queries_agree(objs):
    """The segment queries of one utterance line up: a duration, an
    original id and a landmark span for each segment."""
    utt = objs["Utterances"]
    for i in range(utt.D):
        embeds = utt.get_segmented_embeds_i(i)
        assert len(utt.get_segmented_durations_i(i)) == len(embeds)
        orig = utt.get_original_segmented_embeds_i(i)
        assert len(orig) == len(embeds) and min(orig) >= 0
        spans = utt.get_segmented_landmarks(i)
        assert len(spans) == len(embeds)
        assert spans[-1][1] == utt.landmarks[i][-1]


def test_per_utterance_calls_run(objs):
    """``gibbs_sample_i`` (a block of one), ``get_log_margs_i`` (which puts
    the state back) and ``segment`` (an alias of ``gibbs_sample``)."""
    seg = objs["UnigramAcousticWordseg"]
    am = seg.acoustic_model
    assert np.isfinite(seg.gibbs_sample_i(1, anneal_temp=0.5,
                                          anneal_gibbs_am=True))
    before = (am.stats.counts.clone(), am.assignments.clone())
    margs = seg.get_log_margs_i(2)
    assert len(margs) == len(seg.utterances.get_segmented_embeds_i(2))
    assert np.isfinite(margs).all()
    assert (am.stats.counts == before[0]).all()
    assert (am.assignments == before[1]).all()
    rec = seg.segment(1)
    assert len(rec["log_marg"]) == 1
