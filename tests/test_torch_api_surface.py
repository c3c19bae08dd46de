"""The reference public-API surface on the port's classes: the names of
tests/test_api_surface.py's ``SURFACE`` lists respond on the port's
objects (every class there: ``FBGMM``, ``BigramFBGMM``,
``BigramSmoothLM``, ``KMeans``, ``Utterances``, the three segmenters and
both component views), so do the drivers' batch scorers and the
module-level DP functions, and the per-utterance calls run."""

import numpy as np
import pytest

import segmentalist_torch as pt
from segmentalist_torch.segmenters import kmeans_seg, unigram
from segmentalist_torch.utils.synth import synthetic_corpus

SURFACE = {
    "FBGMM": (
        "setup_components set_K log_prob_z log_prob_X_given_z log_marg "
        "log_marg_i gibbs_sample gibbs_sample_inside_loop_i map_assign_i "
        "get_n_assigned alpha covariance_type lms prior components"
    ),
    "BigramFBGMM": (
        "setup_components log_prob_X_given_z get_n_assigned covariance_type "
        "lms prior"
    ),
    "BigramSmoothLM": (
        "prob_i prob_i_given_j log_prob_vec_i prob_vec_i log_prob_vec_given_j "
        "prob_vec_given_j counts_from_data counts_from_utterance "
        "remove_counts_from_utterance a b bigram_counts intrp_lambda "
        "unigram_counts"
    ),
    "KMeans": "setup_components fit get_n_assigned components",
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
    "BigramAcousticWordseg": (
        "set_fb_type set_lm_counts log_prob_z log_marg "
        "log_marg_i_embed_unigram gibbs_sample_inside_loop_i_embed "
        "gibbs_sample_i gibbs_sample get_vec_embed_log_probs_unigram "
        "get_vec_embed_log_probs_bigram calc_p_continue "
        "get_unsup_transcript_i beta_sent_boundary fb_type "
        "ids_to_utterance_labels lms n_slices_max n_slices_min "
        "time_power_term utterances wip"
    ),
    "SegmentalKMeansWordseg": (
        "segment_i get_vec_embed_neg_len_sqrd_norms segment "
        "get_unsup_transcript_i get_max_unsup_transcript_i "
        "ids_to_utterance_labels n_slices_max n_slices_min utterances wip"
    ),
    "ComponentsView": (
        "add_item del_item del_component log_prior log_post_pred_k "
        "log_post_pred log_marg_k log_marg rand_k map counts prior "
        "get_assignments assignments"
    ),
    "KMeansComponentsView": (
        "add_item del_item del_component neg_sqrd_norm max_neg_sqrd_norm_i "
        "argmax_neg_sqrd_norm_i sum_neg_sqrd_norm get_assignments "
        "get_max_assignments clean_components setup_random_means "
        "assignments counts mean_numerators means random_means"
    ),
}

# beyond the reference: the JAX package's batch scorers
# (segmenters/unigram.py:326, bigram.py:296) and its module-level DP API
# (segmenters/unigram.py:84-156, kmeans_seg.py:60)
EXTRAS = {
    "UnigramAcousticWordseg": "get_vec_embed_log_probs_all",
    "BigramAcousticWordseg": "get_vec_embed_log_probs_unigram_all",
}
MODULE_FUNCTIONS = {
    unigram: "_tri_to_dense _dense_to_tri forward_backward "
             "forward_backward_viterbi",
    kmeans_seg: "forward_backward_kmeans_viterbi",
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
    km = pt.KMeans(X, 4, "rand", device="cpu")
    common = dict(embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                  landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=3,
                  batch_size=2, seed=0, device="cpu")
    useg = pt.UnigramAcousticWordseg(
        pt.FBGMM, am_alpha=1.0, am_K=8, am_param_prior=prior, **common)
    bseg = pt.BigramAcousticWordseg(
        am_K=8, am_param_prior=prior,
        lm_params={"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0},
        fb_type="unigram", **common)
    kseg = pt.SegmentalKMeansWordseg(am_K=8, **common)
    return {"FBGMM": fb, "BigramFBGMM": bseg.acoustic_model,
            "BigramSmoothLM": pt.BigramSmoothLM(0.1, 1.0, 1.0, 8,
                                                device="cpu"),
            "KMeans": km, "Utterances": useg.utterances,
            "UnigramAcousticWordseg": useg, "BigramAcousticWordseg": bseg,
            "SegmentalKMeansWordseg": kseg, "ComponentsView": fb.components,
            "KMeansComponentsView": kseg.acoustic_model.components}


@pytest.mark.parametrize("cls", sorted(SURFACE))
def test_reference_surface_present(objs, cls):
    obj = objs[cls]
    missing = [n for n in SURFACE[cls].split() if not hasattr(obj, n)]
    assert not missing, "%s missing reference names: %s" % (cls, missing)


@pytest.mark.parametrize("cls", sorted(EXTRAS))
def test_batch_scorers_present(objs, cls):
    assert all(callable(getattr(objs[cls], n, None))
               for n in EXTRAS[cls].split())


def test_module_level_functions_present():
    missing = [n for mod, names in MODULE_FUNCTIONS.items()
               for n in names.split() if not callable(getattr(mod, n, None))]
    assert not missing, missing


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
