"""Each kernel's work count against a count made by hand at a tiny shape,
and the state summaries they read against the state they come from."""

import numpy as np
import pytest

import perfbench_tiny  # noqa: F401  (puts the repository on the path)
from perfbench import peaks
from perfbench.work import dp, fixed_chain, fixed_score, full_chain
from perfbench.work import full_item_chain, full_params, full_score

# one block of two utterances: 3 and 2 landmarks, window 2, D 2, K 5
S = {"D": 2, "K": 5, "W": 2, "K_occ": 3, "lengths": np.array([3, 2]),
     "rows": np.array([5, 3]), "occ": np.array([3, 2]),
     "touched": np.array([1, 2]), "steps": np.array([2, 1]),
     "slot_steps": 4, "claimed": 1}


def test_fixed_score():
    w = fixed_score.count(S)
    # pairs 5*3 + 3*2 = 21 at 4*2+6 = 14; rows 8 at 4*2+4 = 12
    assert w.flops == 21 * 14 + 8 * 12
    # rows 8 * (2 + 2) floats; tables (3 + 3) * 2 * 2 floats; 2 rows of
    # 5 weights and counts
    assert w.bytes == 8 * 4 * 4 + 6 * 4 * 4 + 2 * 5 * 8
    assert w.sfu == 21 + 8


def test_full_score():
    w = full_score.count(S)
    # F = 3; a pair 2 (3 + 2) + 2 + 8 = 20
    assert w.flops == 21 * 20
    assert w.bytes == 8 * 4 * 4 + 6 * (3 + 2 + 2) * 4 + 2 * 5 * 8
    assert w.sfu == 2 * 21 + 8


def test_dp():
    w = dp.count(S)
    # forward steps 2 + 1 = 3 at 4*2+2 = 10; nodes 5 at 5*2 = 10
    assert w.flops == 3 * 10 + 5 * 10
    assert w.sfu == 3 * 3 + 5 * 2 * 2
    assert w.bytes == 5 * 2 * 4 * 3 + 5 + 2 * 8


def test_fixed_chain():
    w = fixed_chain.count(S)
    # column steps 2*3 + 1*2 = 8 at 4*2+8 = 16; 3 steps of 2*5 + 2*2
    assert w.flops == 8 * 16 + 3 * 14
    assert w.sfu == 8 + 3 * 2
    assert w.bytes == 3 * (5 + 2 + 1) * 4 + 6 * 2 * 2 * 4 + 2 * 5 * 4


def test_full_chain():
    w = full_chain.count(S)
    # slot steps 4 at 2*4 + 6 + 30 = 44; 3 steps of 8*5 and 4*4 + 12
    assert w.flops == 4 * 44 + 3 * 40 + 3 * 28
    assert w.sfu == 8
    assert w.bytes == 3 * (10 + 3) * 4 + 4 * (4 + 2 + 1) * 4


def test_full_params():
    w = full_params.count(S)
    assert w.flops == pytest.approx(6 * 2 * 8 / 3)
    assert w.bytes == 6 * 2 * 4 * 4


def test_full_item_chain():
    w = full_item_chain.count({"D": 2, "K": 5, "items": 4, "occ_start": 2,
                               "occ_end": 4})
    # 4 items x 3 columns at 2*3 + 6 + 8 = 20; 4 x 8 * 4 for the updates
    assert w.flops == 12 * 20 + 4 * 32
    assert w.sfu == 24
    assert w.bytes == 4 * (5 + 2 + 2) * 4 + 2 * 3 * 7 * 4


def test_seconds_take_the_largest_bound():
    w = peaks.Work(flops=peaks.PEAK_FP32, bytes=2 * peaks.PEAK_BYTES)
    assert w.seconds() == pytest.approx(2.0)


def test_block_summary_counts_the_state():
    from perfbench import trace
    from perfbench.reference import common

    # two utterances of 3 and 2 landmarks, every span of width <= 2
    em = {"utt00000": np.zeros((5, 2), np.float32),
          "utt00001": np.zeros((3, 2), np.float32)}
    vi = {"utt00000": np.array([0, 1, 2, -1, 3, 4]),
          "utt00001": np.array([0, 1, 2])}
    du = {"utt00000": [10, 20, 10, 20, 10], "utt00001": [10, 20, 10]}
    truth = {"utt00000": np.array([0, 0, 1], bool),
             "utt00001": np.array([0, 1], bool)}
    t = common.Tables((em, vi, du, None, truth), 2)
    assert t.seg_ids[0].tolist() == [[0, -1], [2, 1], [4, 3]]
    # before: utt 0 segments [0,1] [2] -> embeds 1, 4; utt 1 [0] [1] -> 5, 7
    b0 = np.array([[0, 1, 1], [1, 1, 0]], bool)
    a0 = np.full(8, -1)
    a0[[1, 4, 5, 7]] = [0, 2, 2, 3]
    # after: utt 0 [0] [1,2] -> 0, 3 (comps 0, 1); utt 1 [0,1] -> 6 (comp 3)
    b1 = np.array([[1, 0, 1], [0, 1, 0]], bool)
    a1 = np.full(8, -1)
    a1[[0, 3, 6]] = [0, 1, 3]
    s = trace.block_summary(t, 5, 2, [0, 1], a0, b0, a1, b1)
    # utt 0's durations list covers packed slots 0-4: its span at slot 5
    # (landmark 2 alone) has no duration and is masked
    assert s["rows"].tolist() == [4, 3]
    assert s["K_occ"] == 3
    # utt 0 alone holds comp 0; utt 1 alone holds comp 3
    assert s["occ"].tolist() == [2, 2]
    assert s["touched"].tolist() == [2, 2]
    assert s["steps"].tolist() == [2, 1]
    # utt 0: steps see 2 then 2 slots (comp 0 touched), claims comp 1;
    # utt 1: 2 slots, comp 3 touched
    assert s["slot_steps"] == 2 + 2 + 2
    assert s["claimed"] == 1
