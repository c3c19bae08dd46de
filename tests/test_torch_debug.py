"""The port's sampler monitoring and validation (``utils/debug.py`` and the
drivers' ``monitor_i`` / ``validate`` / debug-only flags) against the JAX
package.

Monitor parity: from one state carried across with ``interop.load_state``,
the port's ``_monitor_device`` gives the JAX package's candidate scores
(1e-9 relative at float64, ``SCORE_TOL`` at float32), boundary rows and
assignments, for the unigram driver in the three component families, the
bigram driver and segmental k-means.  Then the JAX package's own debug
tests (``tests/test_debug_and_apis.py:63-110``) on the port, and the
validation flags of both packages on healthy and poisoned states.
"""

import logging

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import segmentalist_tpu as jtpu
from segmentalist_tpu.models.bigram_lm import BigramLMState as JaxLMState
from segmentalist_tpu.models.kmeans import KMeansState as JaxKMeansState
from segmentalist_tpu.ops.stats import SuffStats as JaxSuffStats
from segmentalist_tpu.segmenters.bigram import (
    BigramAcousticWordseg as JaxBigram)
from segmentalist_tpu.segmenters.kmeans_seg import (
    SegmentalKMeansWordseg as JaxKMeansSeg)
from segmentalist_tpu.segmenters.unigram import (
    UnigramAcousticWordseg as JaxUnigram)
from segmentalist_tpu.utils import debug as jdbg

import segmentalist_torch as pt
from segmentalist_torch import interop
from segmentalist_torch.utils import debug as dbg
from segmentalist_torch.utils.debug import ValidationError
from segmentalist_torch.utils.synth import synthetic_corpus

D = 4
SCORE_TOL = 1e-4  # float32: |port - JAX| <= SCORE_TOL * max(1, |JAX|)
LM_PARAMS = {"type": "smooth", "intrp_lambda": 0.1, "a": 1.0, "b": 1.0}


def _corpus(seed=11, dtype=None):
    em, vi, du, lm = synthetic_corpus(n_utterances=6, n_landmarks_max=5, D=D,
                                      K_true=3, n_slices_max=3,
                                      seed=seed)[:4]
    if dtype is not None:
        em = {k: v.astype(dtype) for k, v in em.items()}
    return em, vi, du, lm


def _prior(pkg, cov="fixed", dtype=np.float64):
    one = np.ones(D, dtype)
    if cov == "fixed":
        return pkg.FixedVarPrior.create(0.05 * one, 0.0 * one, one)
    S_0 = 0.2 * one if cov == "diag" else 0.2 * np.eye(D, dtype=dtype)
    return pkg.NIW.create(0.0 * one, 0.1, D + 3.0, S_0)


def _corpus_kwargs(seed, dtype=None):
    em, vi, du, lm = _corpus(seed, dtype)
    return dict(embedding_mats=em, vec_ids_dict=vi, durations_dict=du,
                landmarks_dict=lm, p_boundary_init=0.5, n_slices_max=3,
                batch_size=3, seed=seed)


def _unigram(pkg, seed=11, cov="fixed", dtype=None, **kw):
    np.random.seed(seed)  # the JAX init draws from numpy's global RNG
    return pkg.UnigramAcousticWordseg(
        pkg.FBGMM, am_alpha=1.0, am_K=6,
        am_param_prior=_prior(pkg, cov, dtype or np.float64),
        covariance_type=cov, beta_sent_boundary=-1,
        **_corpus_kwargs(seed, dtype), **kw)


def _bigram(pkg, seed=11, dtype=None, **kw):
    np.random.seed(seed)
    return pkg.BigramAcousticWordseg(
        am_K=6, am_param_prior=_prior(pkg, "fixed", dtype or np.float64),
        lm_params=LM_PARAMS, fb_type="unigram", beta_sent_boundary=-1,
        **_corpus_kwargs(seed, dtype), **kw)


def _kmeans(pkg, seed=11, dtype=None, **kw):
    np.random.seed(seed)
    return pkg.SegmentalKMeansWordseg(am_K=6, **_corpus_kwargs(seed, dtype),
                                      **kw)


class _Jax:
    """The JAX package's names under the port's, for the builders above."""

    FBGMM, FixedVarPrior, NIW = jtpu.FBGMM, jtpu.FixedVarPrior, jtpu.NIW
    UnigramAcousticWordseg = JaxUnigram
    BigramAcousticWordseg = JaxBigram
    SegmentalKMeansWordseg = JaxKMeansSeg


def _port(build, **kw):
    return build(pt, device="cpu", **kw)


def _jax_state(jseg):
    """The JAX segmenter's state under ``interop``'s keys."""
    am = jseg.acoustic_model
    out = {"X": np.asarray(am.X), "boundaries": np.asarray(jseg._boundaries_dev)}
    if hasattr(am, "state"):  # k-means
        out.update({k: np.asarray(v) for k, v in am.state._asdict().items()})
        out["random_means"] = np.asarray(am.random_means)
        return out
    out.update({k: np.asarray(v) for k, v in am.stats._asdict().items()})
    out["assignments"] = np.asarray(am.assignments)
    out.update({k: np.asarray(v) for k, v in am.prior._asdict().items()})
    if hasattr(jseg, "lm"):
        out.update({k: np.asarray(v)
                    for k, v in jseg.lm.state._asdict().items()})
    return out


# --------------------------------------------------------- monitor parity

MONITORED = {
    "unigram_fixed": lambda pkg, **kw: _unigram(pkg, cov="fixed", **kw),
    "unigram_diag": lambda pkg, **kw: _unigram(pkg, cov="diag", **kw),
    "unigram_full": lambda pkg, **kw: _unigram(pkg, cov="full", **kw),
    "bigram": _bigram,
    "kmeans": _kmeans,
}


def _monitors(seg, to_numpy):
    return [tuple(to_numpy(a) for a in seg._monitor_device(i))
            for i in range(seg.utterances.D)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(MONITORED))
def test_monitor_matches_jax(name, dtype):
    """Every utterance's monitor values, from one state (after one JAX
    sweep at ``dtype``): the boundary rows and assignments identical to
    the JAX package's, the scores to 1e-9 relative of its float64 monitor
    on that state.  At float32 the port's scores are held to SCORE_TOL
    (relative, at least 1) of the JAX float64 monitor on the same float32
    state: the JAX package's own float32 monitor is off its float64 one by
    up to 1.5e-4 here in the fixed-variance family (the expanded
    Mahalanobis form of ``log_post_pred_batch``; ROADMAP's reference
    caveats), where the port scores with K1's direct form."""
    build = MONITORED[name]
    jseg = build(_Jax, dtype=dtype)
    if name == "kmeans":
        jseg.segment(1, validate=True)
    else:
        jseg.gibbs_sample(1, validate=True)
    state = _jax_state(jseg)
    tseg = build(pt, dtype=dtype, device="cpu")
    interop.load_state(tseg, state)
    got = _monitors(tseg, lambda a: a.numpy())
    want = _monitors(jseg, np.asarray)
    if dtype == "float32":  # the JAX monitor at float64 on the same state
        jseg64 = build(_Jax, dtype="float64")
        _load_jax_state(jseg64, {
            k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in state.items()})
        want = [(s64, b, k) for (s64, _, _), (_, b, k)
                in zip(_monitors(jseg64, np.asarray), want)]
    for (ts, tb, tk), (js, jb, jk) in zip(got, want):
        assert ts.dtype == np.dtype(dtype)
        npt.assert_array_equal(np.isinf(ts), np.isinf(js))
        fin = np.isfinite(js)
        assert fin.any()
        if dtype == "float64":
            npt.assert_allclose(ts[fin], js[fin], rtol=1e-9, atol=0)
        else:
            err = np.abs(ts[fin] - js[fin]) / np.maximum(1.0,
                                                         np.abs(js[fin]))
            assert err.max() <= SCORE_TOL, err.max()
        npt.assert_array_equal(tb, jb)
        npt.assert_array_equal(tk, jk)


def _load_jax_state(jseg, s):
    """Put the ``interop``-keyed state ``s`` into a JAX segmenter."""
    am = jseg.acoustic_model
    j = {k: jnp.asarray(v) for k, v in s.items()}
    am.X = j["X"]
    jseg._boundaries_dev = j["boundaries"]
    if hasattr(am, "state"):
        am.state = JaxKMeansState(j["assignments"], j["counts"], j["sum_x"])
        am.random_means = j["random_means"]
        return
    am.log_prior_vec = am.cov.log_prior_batch(am.prior, am.X)
    am.stats = JaxSuffStats(j["counts"], j["sum_x"], j["sum_sq"])
    am.assignments = j["assignments"]
    if hasattr(jseg, "lm"):
        jseg.lm.state = JaxLMState(j["unigram_counts"], j["bigram_counts"])


# ------------------------------------------- the JAX debug tests, ported

@pytest.mark.parametrize("family", ["unigram", "bigram", "kmeans"])
def test_monitor_and_validate(family, caplog):
    """tests/test_debug_and_apis.py::test_monitor_and_validate on the port:
    two sweeps log four monitor lines on the ``segmentalist_torch``
    logger."""
    seg = _port({"unigram": _unigram, "bigram": _bigram,
                 "kmeans": _kmeans}[family])
    with caplog.at_level(logging.DEBUG, logger="segmentalist_torch"):
        if family == "kmeans":
            rec = seg.segment(2, monitor_i=1, validate=True)
            assert np.isfinite(rec["sum_neg_sqrd_norm"]).all()
        else:
            rec = seg.gibbs_sample(2, monitor_i=1, validate=True)
            assert np.isfinite(rec["log_marg"]).all()
    msgs = [r.message for r in caplog.records
            if "monitor utterance 1" in r.message]
    assert len(msgs) == 4  # two sweeps x (state line + score table)
    assert any("candidate scores" in m for m in msgs)
    assert any("transcript" in m for m in msgs)


@pytest.mark.parametrize("family", ["unigram", "kmeans"])
def test_debug_only_flags_touch_one_utterance(family):
    """debug_gibbs_only / segment_debug_only resample only the monitored
    utterance: every other utterance's boundaries and assignments stay,
    and the host order RNG is not drawn from."""
    seg = _port(_unigram if family == "unigram" else _kmeans)
    bounds0 = seg.utterances.boundaries.copy()
    assign0 = seg.acoustic_model.assignments.numpy().copy()
    rng0 = seg._rng.get_state()[2]
    if family == "kmeans":
        seg.segment(2, monitor_i=1, segment_debug_only=True)
    else:
        seg.gibbs_sample(2, monitor_i=1, debug_gibbs_only=True)
    others = [i for i in range(seg.utterances.D) if i != 1]
    npt.assert_array_equal(seg.utterances.boundaries[others],
                           bounds0[others])
    own = set(seg.utterances.seg_ids[1].numpy().ravel().tolist()) - {-1}
    rest = np.array([e not in own for e in range(len(assign0))])
    npt.assert_array_equal(seg.acoustic_model.assignments.numpy()[rest],
                           assign0[rest])
    assert seg._rng.get_state()[2] == rng0
    with pytest.raises(AssertionError, match="requires monitor_i"):
        if family == "kmeans":
            seg.segment(1, segment_debug_only=True)
        else:
            seg.gibbs_sample(1, debug_gibbs_only=True)


def _poison_sum_x(am):
    if hasattr(am, "stats"):
        am.stats = am.stats._replace(
            sum_x=am.stats.sum_x.clone().index_put_(
                (torch.tensor(0), torch.tensor(0)),
                torch.tensor(float("nan"), dtype=am.stats.sum_x.dtype)))


def test_validate_raises_on_poisoned_state():
    """A NaN in sum_x[0, 0] raises ValidationError naming sum_x, with the
    JAX package's message on the same poisoned state."""
    jseg = _unigram(_Jax, seed=12)
    jam = jseg.acoustic_model
    jam.stats = jam.stats._replace(
        sum_x=jam.stats.sum_x.at[0, 0].set(jnp.nan))
    with pytest.raises(jdbg.ValidationError) as jerr:
        jseg.gibbs_sample(1, validate=True)
    tseg = _port(_unigram, seed=12)
    _poison_sum_x(tseg.acoustic_model)
    with pytest.raises(ValidationError, match="sum_x") as terr:
        tseg.gibbs_sample(1, validate=True)
    assert str(terr.value) == str(jerr.value)


def test_validate_passes_on_healthy_run():
    seg = _port(_bigram, seed=13)
    rec = seg.gibbs_sample(2, validate=True)
    assert np.isfinite(rec["log_marg"]).all()


# ------------------------------------------------------ validation flags

def _poisonings(kind, lengths):
    """(name, edit of the JAX state dict): each breaks one invariant."""
    def nan_sum_x(s):
        s["sum_x"][0, 0] = np.nan

    def nan_sum_sq(s):
        s["sum_sq"][1, 0] = np.nan

    def negative_count(s):
        s["counts"][0] -= 100

    def stray_assignment(s):
        s["assignments"][np.nonzero(s["assignments"] < 0)[0][0]] = 0

    def no_final_boundary(s):
        s["boundaries"][2, lengths[2] - 1] = False

    def negative_lm(s):
        s["bigram_counts"][0, 1] = -1

    out = [("healthy", lambda s: None), ("nan_sum_x", nan_sum_x),
           ("negative_count", negative_count),
           ("stray_assignment", stray_assignment),
           ("no_final_boundary", no_final_boundary)]
    if kind != "kmeans":
        out.append(("nan_sum_sq", nan_sum_sq))
    if kind == "bigram":
        out.append(("negative_lm", negative_lm))
    return out


@pytest.mark.parametrize("kind", ["unigram", "bigram", "kmeans"])
def test_validation_flags_match_jax(kind):
    """The port's flags equal the JAX package's flag functions on a
    healthy state and on each poisoned one."""
    build = {"unigram": _unigram, "bigram": _bigram, "kmeans": _kmeans}[kind]
    jseg = build(_Jax)
    base = _jax_state(jseg)
    lengths = np.asarray(jseg.utterances.lengths_dev)
    for name, edit in _poisonings(kind, lengths):
        s = {k: np.array(v) for k, v in base.items()}
        edit(s)
        j = {k: jnp.asarray(v) for k, v in s.items()}
        if kind == "kmeans":
            want = jdbg.kmeans_validation_flags(
                JaxKMeansState(j["assignments"], j["counts"], j["sum_x"]),
                j["boundaries"], jnp.asarray(lengths))
        else:
            stats = JaxSuffStats(j["counts"], j["sum_x"], j["sum_sq"])
            args = (stats, j["assignments"], j["boundaries"],
                    jnp.asarray(lengths))
            want = (jdbg.bigram_validation_flags(
                *args, JaxLMState(j["unigram_counts"], j["bigram_counts"]))
                    if kind == "bigram"
                    else jdbg.fbgmm_validation_flags(*args))
        tseg = build(pt, device="cpu")
        interop.load_state(tseg, s)
        got = tseg._validate_device()
        assert got.dtype == torch.bool
        npt.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        assert got.numpy().all() == (name == "healthy"), name
        checks = {"unigram": dbg.FBGMM_CHECKS, "bigram": dbg.BIGRAM_CHECKS,
                  "kmeans": dbg.KMEANS_CHECKS}[kind]
        assert checks == {"unigram": jdbg.FBGMM_CHECKS,
                          "bigram": jdbg.BIGRAM_CHECKS,
                          "kmeans": jdbg.KMEANS_CHECKS}[kind]


def test_check_validation_names_the_sweep_and_invariants():
    flags = [torch.tensor([True] * 5),
             torch.tensor([False, True, True, False, True])]
    with pytest.raises(ValidationError) as err:
        dbg.check_validation(flags, dbg.FBGMM_CHECKS)
    assert str(err.value) == (
        "sampler invariant violated at iteration 1: non-finite component "
        "sum_x, count/assignment-vector mismatch")
    with pytest.raises(jdbg.ValidationError) as jerr:
        jdbg.check_validation([np.asarray(f) for f in flags],
                              jdbg.FBGMM_CHECKS)
    assert str(jerr.value) == str(err.value)
