"""The FBGMM's sequential Gibbs sweep as one chain over items: kernel K10
and its plain version.

Counterpart of the JAX package's sequential sweep
(``segmentalist_tpu/models/fbgmm.py:517-570``, a ``lax.scan`` with no
``pallas_call``; with the delete off, ``reassign_items`` at ``:351-381``).
For each item i in order, with statistics updated by the items before it:

  1. (delete) item i leaves its old column ``k_old[i]`` if that is >= 0;
  2. every column is scored: ``w[k] + (cnt[k] > 0 ? fit(x_i, k) :
     log_prior[i])`` with ``w[k] = lms log(alpha/K + cnt[k])``;
  3. the annealed Gumbel-max ``argmax(l / temp + noise[i])`` (-inf stays
     -inf; ``use_argmax``: ``argmax(l)``), ties to the lowest index;
  4. a draw on an empty column moves to the first empty one (else K - 1);
  5. item i joins the drawn column.

The kernel is the chain template's item mode (``csrc/diag_family_chain.cuh``,
``gibbs_items_kernel``) with the fixed-variance policy of K3
(``csrc/fixedvar_chain.cu``) or the exact diag policy
(``csrc/diag_chain.cu::DiagExactChain``: the per-dimension ``log1p`` sum of
``components_diag``, not K6's grouped form, and lgamma from
:func:`cuda_diag_chain.gr_table`).  The plain version is the chain loop of
the other plain chains (``cuda_chain._chain_plain``) with the delete and
the same column models, so on shared noise the two sample the same ks and
end on the same statistics.  A CUDA tensor takes the kernel (its launch
plan raises where a shape does not fit), a CPU tensor the plain version.
The full-covariance family has no item kernel: ``models.fbgmm`` runs its
per-item step in PyTorch.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_chain import (_LOG_2PI, ChainPlan, FixedVarCols, _chain_plain,
                         pick_form)
from .cuda_diag_chain import _HALF_LOG_PI, DiagCols, gr_table, prior_terms
from .stats import SuffStats

FAMILIES = ("fixed", "diag")

launches = 0  # K10 launches since the last reset


def item_chain(family: str, X, log_prior, noise, k_old, stats: SuffStats,
               prior, alpha: float, K: int, lms: float = 1.0,
               temp: float = 1.0, use_argmax: bool = False):
    """One chain over n items (kernel K10).

    ``family`` "fixed" (``prior`` a FixedVarPrior) or "diag" (an NIW with a
    [D] ``S_0``); X [n, D] the items' vectors in chain order; log_prior [n]
    their prior log densities; noise [n, K] standard Gumbel noise (may be
    None with ``use_argmax``); k_old [n] int32 each item's old column, -1
    for none (all -1: no delete); ``stats`` the model's statistics
    (counts [K] int32, sum_x and sum_sq [K, D]).  The diag family reads
    the statistics' total count once, to size its lgamma table: no count
    the chain reaches exceeds the total plus n.

    Returns (ks [n] int32, the final SuffStats).
    """
    if family not in FAMILIES:
        raise ValueError("no item chain for covariance type %r" % (family,))
    if X.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=X.device),
                SuffStats(*(t.clone() for t in stats)))
    args = item_chain_inputs(family, X, log_prior, noise, k_old, stats,
                             prior, alpha, K, lms, temp, use_argmax)
    run = _launch if cuda_lib.use_kernel(X) else item_chain_plain
    return item_chain_result(*run(*args))


def item_chain_inputs(family, X, log_prior, noise, k_old, stats, prior,
                      alpha, K, lms=1.0, temp=1.0,
                      use_argmax=False) -> tuple:
    """The arguments of :func:`item_chain_plain` and of the kernel's launch
    from :func:`item_chain`'s: the [1, ...] item tensors, the feature-major
    statistics, the prior's terms and the options."""
    n = X.shape[0]
    if noise is None:
        if not use_argmax:
            raise ValueError("noise is required unless use_argmax")
        noise = X.new_zeros((n, K))
    data = (X[None].contiguous(), log_prior[None].contiguous(),
            noise[None].contiguous(), k_old[None].contiguous(),
            stats.counts[None].contiguous(),
            stats.sum_x.T[None].contiguous(),
            stats.sum_sq.T[None].contiguous())
    if family == "fixed":
        prec0 = 1.0 / prior.var_0
        terms = (1.0 / prior.var, prec0, prec0 * prior.mu_0)
    else:
        k0m0, snp0, k0 = prior_terms(prior.m_0, prior.k_0, prior.S_0)
        max_count = int(stats.counts.sum()) + n
        v0 = float(prior.v_0)
        terms = (k0m0, snp0, gr_table(v0, max_count, X.dtype, X.device),
                 k0, v0)
    return (family, *data, terms, float(temp), float(alpha), int(K),
            float(lms), bool(use_argmax))


def item_chain_result(ks, cnt, sums):
    """(ks [n], SuffStats) from the kernel's or the plain version's
    outputs (ks [1, n], counts [1, K], sums [1, 2, D, K])."""
    return ks[0], SuffStats(cnt[0].to(torch.int32), sums[0, 0].T.contiguous(),
                            sums[0, 1].T.contiguous())


def item_chain_plain(family, Xe, log_prior_e, gumbel, k_old, counts, sum_xT,
                     sum_sqT, terms, temp, alpha, K, lms, use_argmax):
    """Plain PyTorch version of K10 on the kernel's [1, ...] inputs
    (``terms``: prec, prec0, p0m0 for "fixed"; k0 m0, snp0, the lgamma
    table, k0, v0 for "diag").  Returns (ks [1, n] int32, counts [1, K],
    sums [1, 2, D, K])."""
    if family == "fixed":
        cols = FixedVarCols(*terms)
    else:
        k0m0, snp0, gr, k0, v0 = terms
        cols = DiagCols(k0m0, snp0, k0, v0, gr_tab=gr)

    def weights(cnt, j_prev):
        return lms * torch.log(alpha / K + cnt)

    embeds = torch.zeros(k_old.shape, dtype=torch.int32, device=Xe.device)
    ks, cnt, sums = _chain_plain(embeds, Xe, log_prior_e, gumbel, counts,
                                 (sum_xT, sum_sqT), cols, temp, use_argmax,
                                 weights, k_old=k_old)
    return ks, cnt.to(torch.int32), torch.stack(sums, 1)


# Per family: the tables of the smem and global forms, the hoisted terms,
# the prior vectors (K10 carries two sums, sx and ssq, in both).
_TABLES = {"fixed": {"smem": 2, "global": 1}, "diag": {"smem": 2, "global": 2}}
_TERMS = {"fixed": 1, "diag": 2}
_PRIOR = {"fixed": 3, "diag": 2}
_SUMS = 2


def col_arrays(family: str, global_tables: bool) -> int:
    """Column arrays of the CTA: cnt, the hoisted terms, the weight term and
    the touched slot (the global form's device-memory array reserves one
    more row, as the template sizes it for the bigram chains)."""
    return 3 + _TERMS[family] + (1 if global_tables else 0)


def smem_bytes(family: str, global_tables: bool, D: int, K: int) -> int:
    """Dynamic shared memory of K10's CTA, as the kernel reserves it
    (``csrc/diag_family_chain.cuh::smem_words`` of the policy, item mode).
    The smem form: per column its tables, cnt, the hoisted terms, the
    weight term, the touched slot and a double-buffered noise value.  Both
    forms: x and the log prior [3, D + 1]; the prior vectors, and the logs
    and running sums of the adding and of the deleting update [2 (1 + 2),
    D]."""
    per_col = _TABLES[family]["smem"] * D + col_arrays(family, False) + 2
    words = ((0 if global_tables else per_col * K) + 3 * (D + 1)
             + (_PRIOR[family] + 2 * (1 + _SUMS)) * D)
    return 4 * words


def launch_plan(family: str, D: int, K: int, smem_limit: int) -> ChainPlan:
    """The form of K10 for D dims and K columns (pure Python): "smem" where
    the tables fit the ``smem_limit`` bytes of dynamic shared memory a CTA
    may take, else "global".  Raises if neither fits.  The chain's length
    does not enter: the steps are the items, read from device memory."""
    return pick_form(lambda g: smem_bytes(family, g, D, K), K, 0, smem_limit,
                     "%s item" % family)


def card_plan(family: str, D: int, K: int) -> ChainPlan:
    """:func:`launch_plan` under the current card's limit (its opt-in
    shared memory a block less the kernel's static shared memory)."""
    lib = cuda_lib.library()
    limit = (lib.fixedvar_items_smem_limit() if family == "fixed"
             else lib.diag_items_smem_limit())
    if limit < 0:
        cuda_lib.check(-limit, "%s_items_smem_limit" % family)
    return launch_plan(family, D, K, limit)


def _launch(family, Xe, log_prior_e, gumbel, k_old, counts, sum_xT, sum_sqT,
            terms, temp, alpha, K, lms, use_argmax):
    global launches
    _, S, D = Xe.shape
    dev, f32 = Xe.device, torch.float32
    req = cuda_lib.require
    req(Xe, "X", f32, (1, S, D), dev)
    req(log_prior_e, "log_prior", f32, (1, S), dev)
    req(gumbel, "noise", f32, (1, S, K), dev)
    req(k_old, "k_old", torch.int32, (1, S), dev)
    req(counts, "counts", torch.int32, (1, K), dev)
    req(sum_xT, "sum_x", f32, (1, D, K), dev)
    req(sum_sqT, "sum_sq", f32, (1, D, K), dev)
    for i, t in enumerate(terms[:2] if family == "diag" else terms):
        req(t, "prior term %d" % i, f32, (D,), dev)
    if family == "diag":
        req(terms[2], "gr", f32, (terms[2].shape[0],), dev)
    plan = card_plan(family, D, K)
    glob = plan.form == "global"
    ks = torch.empty((1, S), dtype=torch.int32, device=dev)
    cnt = torch.empty((1, K), dtype=torch.int32, device=dev)
    sums = torch.empty((1, _SUMS, D, K), dtype=f32, device=dev)
    touched = torch.empty((1, 2 * S, _SUMS, D), dtype=f32, device=dev)
    tab_g = col_g = None
    if glob:
        tab_g = torch.empty((1, _TABLES[family]["global"], D, K), dtype=f32,
                            device=dev)
        col_g = torch.empty((1, col_arrays(family, True), K), dtype=f32,
                            device=dev)
    p = cuda_lib.ptr
    head = (p(Xe), p(log_prior_e), p(gumbel), p(k_old), p(counts),
            p(sum_xT), p(sum_sqT))
    tail = (p(touched), p(tab_g), p(col_g), p(ks), p(cnt), p(sums), 1, S, D,
            K, int(glob), plan.threads, alpha / K, lms, temp)
    lib = cuda_lib.library()
    if family == "fixed":
        err = lib.fixedvar_items_launch(
            *head, *(p(t) for t in terms), *tail, -0.5 * D * _LOG_2PI,
            int(use_argmax), cuda_lib.stream_of(Xe))
    else:
        k0m0, snp0, gr, k0, v0 = terms
        err = lib.diag_items_launch(
            *head, p(k0m0), p(snp0), p(gr), k0, v0, *tail, _HALF_LOG_PI,
            int(use_argmax), cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "%s_items" % family)
    launches += 1
    return ks, cnt, sums

