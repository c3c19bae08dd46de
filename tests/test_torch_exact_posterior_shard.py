"""The per-shard mode's move against the exact kernel
(tests/test_exact_posterior.py:239) on the port's own noise.

The explicit-collective sweep must sample utterance 0's move from the same
exact kernel as one device: each rank conditions on the same frozen
snapshot, so the move's distribution is unchanged.  The state is the JAX
test's, carried across by ``interop.load_state``; the two gloo ranks draw
from their own generators (``shard_sweep.rank_generator``).  A file of its
own: its one spawn of two ranks runs 2500 moves.
"""

import numpy as np

from segmentalist_torch import interop
from segmentalist_torch.parallel import dryrun
from segmentalist_torch.parallel.mesh import shard_segmenter
from segmentalist_torch.parallel.shard_sweep import use_shard_map_sweep
from test_torch_exact_posterior import (_exact_move_kernel, _pattern_embeds,
                                        two_utterance_segmenter)
from torch_oracle import anchor, check_frequencies, jax_state, move_outcomes

SHARD_TRIALS = 2500


def shard_moves(mesh, state, n_trials):
    """Rank job: the two-utterance segmenter from ``state`` on the mesh in
    the per-shard mode (batch 2, one utterance a rank a block), then
    ``n_trials`` moves of utterance 0 from that state, each rank drawing
    from its own generator; returns rank 0's outcomes (utterance 0 is its
    row 0) as a Counter (an empty one on the other ranks), and every
    rank's final replicated state."""
    seg, _ = two_utterance_segmenter(dryrun.mesh_device(mesh).type)
    interop.load_state(seg, state)
    seg.batch_size = 2
    shard_segmenter(seg, mesh)
    use_shard_map_sweep(seg, mesh)
    freq = move_outcomes(seg, lambda: seg.gibbs_sample_i(0), 3,
                         _pattern_embeds, n_trials,
                         read=seg._shard.rank == 0)
    am = seg.acoustic_model
    return freq, [t.cpu().numpy() for t in (am.assignments, *am.stats)]


def test_shard_map_single_move_matches_exact_kernel():
    """The per-shard (explicit-collective) mode samples utterance 0's move
    from the same exact kernel as one device: each rank conditions on the
    same frozen snapshot, so the move's distribution is unchanged.  All
    2500 moves run in one spawn of two gloo ranks."""
    import test_exact_posterior as jt

    jseg, emb0 = jt._build_two_utterance_segmenter()
    seg = anchor(two_utterance_segmenter("cpu")[0], jseg)
    exact = _exact_move_kernel(seg, emb0)
    res = dryrun.launch(shard_moves, 2, args=(jax_state(jseg), SHARD_TRIALS),
                        device="cpu", timeout=600.0)
    (freq, final0), (_, final1) = res
    for a, b in zip(final0, final1):  # the replicated state agrees
        np.testing.assert_array_equal(a, b)
    assert sum(freq.values()) == SHARD_TRIALS
    check_frequencies(exact, freq, SHARD_TRIALS, 0.05, n_sigma=None)
