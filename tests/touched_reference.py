"""The touched-slot tables derived over every slot of the [B, S] table, as
``segmenters.fullcov.touched_leave_out`` derived them before it derived
the live slots alone: the reference of its CPU and card tests.  Imports
torch and the port only (no JAX), so the card's tests take it too."""

import torch

from segmentalist_torch.models import components_full as cf
from segmentalist_torch.ops import stats as st
from segmentalist_torch.segmenters import fullcov


def all_slot_covar(prior, stats, X, old_embeds, old_ks):
    """(tk, counts, m_n, predictive scale matrices, dof), all [B, S, ...],
    over every slot, pads and duplicates included (they take the
    statistics of ``ks_safe``)."""
    B, S = old_ks.shape
    D = X.shape[-1]
    valid = (old_embeds >= 0) & (old_ks >= 0)
    ks_safe = old_ks.clamp_min(0).long()
    same = ((old_ks[:, :, None] == old_ks[:, None, :])
            & valid[:, :, None] & valid[:, None, :])
    earlier = torch.ones((S, S), dtype=torch.bool, device=X.device).tril(-1)
    tk = torch.where(valid & ~(same & earlier).any(-1), old_ks, -1)
    x_old = torch.where(valid[..., None], X[old_embeds.clamp_min(0).long()],
                        0.0)
    same_f = same.to(X.dtype)
    pk = st.sym_pack(D, X.device)
    lo_counts = (stats.counts[ks_safe] - same.sum(-1)).to(torch.int32)
    lo_sum_x = stats.sum_x[ks_safe] - same_f @ x_old
    lo_sum_sq_p = (stats.sum_sq[:, pk.iu0, pk.iu1][ks_safe]
                   - same_f @ st.packed_outer(x_old))
    return (tk, lo_counts, *cf._derive_covar(prior, lo_counts, lo_sum_x,
                                             st.unpack_sym(lo_sum_sq_p, D)))


def all_slot_leave_out(prior, stats, X, old_embeds, old_ks):
    """(tk, counts, PredParams [B, S, ...]) over every slot."""
    tk, lo_counts, m_n, covar, v = all_slot_covar(prior, stats, X,
                                                  old_embeds, old_ks)
    inv, logdet, L_inv = cf._chol_inv_logdet(covar)
    return tk, lo_counts, cf.PredParams(m_n, inv, logdet, v, L_inv)


def all_slot_touched(prior, stats, X, old_embeds, old_ks):
    """A ``Touched`` whose live rows are every slot of the table, from
    :func:`all_slot_leave_out`: the kernels' inputs built from it are the
    all-slot tables."""
    tk, counts, params = all_slot_leave_out(prior, stats, X, old_embeds,
                                            old_ks)
    B, S = tk.shape
    return fullcov.Touched(
        tk, counts, torch.arange(B * S, device=tk.device),
        cf.PredParams(*(p.reshape((B * S,) + p.shape[2:]) for p in params)))
