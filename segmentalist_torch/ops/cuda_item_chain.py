"""The FBGMM's sequential Gibbs sweep as one chain over items: kernels K10
(the fixed and diag families) and K11 (the full family), and their plain
versions.

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

K10 (``csrc/item_chain.cuh``, ``items_kernel``) runs on a thread-block
cluster of C CTAs, each the owner of K/C columns with their tables and
running sums on chip (:func:`item_launch_plan`), with the column model of
the chain template's fixed-variance policy (``csrc/fixedvar_chain.cu``)
or its exact diag policy (``csrc/diag_chain.cu::DiagExactChain``: the
per-dimension ``log1p`` sum of ``components_diag``, not K6's grouped form,
and lgamma from :func:`cuda_diag_chain.gr_table`).  Its plain version is
the chain loop of the other plain chains (``cuda_chain._chain_plain``)
with the delete and the same column models.

K11 (``csrc/fullcov_item_chain.cu``, ``fullcov_items_kernel``) keeps each
occupied column's predictive parameters (m_n, the inverse Cholesky factor
L^-1 of the scale matrix, its log determinant) and re-derives a column
from its statistics whenever an item joins or leaves it: the JAX step with
``components_full``, scored in the whitened form ``|L^-1 (x - m_n)|^2``.
Its plain version, :func:`full_chain_plain`, runs the same arithmetic in
the same order (:func:`chol_inv_logdet`: no ``torch.linalg``, whose orders
a kernel cannot reproduce), and the count-only Student-t terms of both come
from one exact ``torch.lgamma`` table (:func:`full_count_terms`).

On shared noise each kernel and its plain version sample the same ks and
end on the same statistics.  A CUDA tensor takes the kernel (its launch
plan raises where a shape does not fit), a CPU tensor the plain version.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import cuda_lib
from .cuda_chain import _LOG_2PI, FixedVarCols, _chain_plain
from .cuda_diag_chain import _HALF_LOG_PI, DiagCols, gr_table, prior_terms
from .random import annealed_gumbel_max
from .stats import SuffStats, canonicalize_new_component

FAMILIES = ("fixed", "diag", "full")

launches = 0  # K10 launches since the last reset
full_launches = 0  # K11 launches since the last reset


def item_chain(family: str, X, log_prior, noise, k_old, stats: SuffStats,
               prior, alpha: float, K: int, lms: float = 1.0,
               temp: float = 1.0, use_argmax: bool = False):
    """One chain over n items (kernel K10; K11 for the full family).

    ``family`` "fixed" (``prior`` a FixedVarPrior), "diag" (an NIW with a
    [D] ``S_0``) or "full" (an NIW with a [D, D] ``S_0``); X [n, D] the
    items' vectors in chain order; log_prior [n] their prior log
    densities; noise [n, K] standard Gumbel noise (may be None with
    ``use_argmax``); k_old [n] int32 each item's old column, -1 for none
    (all -1: no delete); ``stats`` the model's statistics (counts [K]
    int32, sum_x [K, D], sum_sq [K, D] or, full, [K, D, D]).  The diag and
    full families read the statistics' total count once, to size their
    lgamma tables: no count the chain reaches exceeds the total plus n.

    Returns (ks [n] int32, the final SuffStats).
    """
    if family not in FAMILIES:
        raise ValueError("no item chain for covariance type %r" % (family,))
    if X.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=X.device),
                SuffStats(*(t.clone() for t in stats)))
    if family == "full":
        args = full_chain_inputs(X, log_prior, noise, k_old, stats, prior,
                                 alpha, K, lms, temp, use_argmax)
        run = _launch_full if cuda_lib.use_kernel(X) else full_chain_plain
        return run(*args)
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


_LOG_PI = math.log(math.pi)
# K11's plan (csrc/fullcov_item_chain.cu): the warp form up to D 32 (a
# derivation on one warp), the CTA form up to D 256; clusters of C CTAs,
# at least enough that a CTA owns at most FULL_COLS_CTA columns, where the
# tables fit on chip; up to FULL_SCORE_WARPS scoring warps and two update
# warps a CTA in the warp form, 1024 threads in the CTA form.
FULL_WARP_D = 32
FULL_MAX_D = 256
FULL_CLUSTERS = (1, 2, 4, 8, 16)
FULL_COLS_CTA = 128
FULL_SCORE_WARPS = 6
FULL_CTA_THREADS = 1024


def full_count_terms(v0: float, D: int, max_count: int, dtype,
                     device) -> torch.Tensor:
    """[max_count + 1] the count-only terms of the full family's Student-t
    log density for every count c up to ``max_count``, with v = v0 + c - D
    + 1 its degrees of freedom: ``lgamma((v + D)/2) - lgamma(v/2) - D/2
    log v - D/2 log pi``, in ``components_full._student_t_from_maha``'s
    order (exact ``torch.lgamma``, as JAX's ``gammaln``).  K11 and its
    plain version both read it."""
    v = ((float(v0) + torch.arange(max_count + 1, dtype=dtype,
                                   device=device)) - D) + 1.0
    return (((torch.lgamma((v + D) / 2.0) - torch.lgamma(v / 2.0))
             - D / 2.0 * torch.log(v)) - D / 2.0 * _LOG_PI)


def chol_inv_logdet(covar):
    """(L^-1, log det) of SPD matrices [..., D, D], L their lower Cholesky
    factor, in K11's order: the factorisation right-looking (D vector
    steps, each taking out one column), then L^-1 by forward substitution
    the same way, so every element's sum still runs in ascending k as in
    the JAX package's left-looking unrolled form
    (``components_full.py:70-135``); log det = 2 sum_i log L_ii in
    ascending i.  No ``torch.linalg``: LAPACK's and cuSOLVER's orders
    cannot be reproduced in a kernel."""
    A = covar.clone()
    D = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(D):
        d = torch.sqrt(A[..., j, j])
        col = A[..., j + 1:, j] / d[..., None]
        L[..., j, j] = d
        L[..., j + 1:, j] = col
        A[..., j + 1:, j + 1:] = (A[..., j + 1:, j + 1:]
                                  - col[..., :, None] * col[..., None, :])
    Y = torch.zeros_like(A)
    acc = torch.zeros_like(A)  # acc[i, j] = sum_k<i L[i, k] Y[k, j] so far
    for k in range(D):
        lkk = L[..., k, k]
        Y[..., k, :k] = -acc[..., k, :k] / lkk[..., None]
        Y[..., k, k] = 1.0 / lkk
        acc[..., k + 1:, :k + 1] = (acc[..., k + 1:, :k + 1]
                                    + L[..., k + 1:, k, None]
                                    * Y[..., k, None, :k + 1])
    logdet = torch.zeros_like(A[..., 0, 0])
    for i in range(D):
        logdet = logdet + torch.log(L[..., i, i])
    return Y, 2.0 * logdet


class FullCols:
    """The full family's column model of K11's plain version: per column
    m_n [K, D], L^-1 [K, D, D] and log det [K], derived for occupied
    columns only (an empty column's entries are never read: it scores its
    item's prior density).  ``derive`` is ``components_full._derive_covar``
    in its order, then :func:`chol_inv_logdet`; the fit is the Student-t
    log density ``(terms[c] - 0.5 log det) - ((v + D)/2) log1p(maha / v)``
    with ``maha = |L^-1 (x - m_n)|^2``, both sums in ascending order."""

    def __init__(self, k0m0, snp0, cterms, k0, v0):
        self.k0m0, self.snp0, self.cterms = k0m0, snp0, cterms
        self.k0, self.v0 = k0, v0

    def dof(self, cnt, D):
        return ((self.v0 + cnt) - D) + 1.0

    def derive(self, idx, cnt, sum_x, sum_sq):
        """Re-derive the columns ``idx`` from their counts and sums."""
        D = sum_x.shape[-1]
        n = cnt[idx]
        kn = self.k0 + n
        m = (self.k0m0 + sum_x[idx]) / kn[:, None]
        scale = (kn + 1.0) / (kn * self.dof(n, D))
        covar = scale[:, None, None] * (
            (self.snp0 + sum_sq[idx])
            - kn[:, None, None] * (m[:, :, None] * m[:, None, :]))
        self.m[idx] = m
        self.linv[idx], self.ld[idx] = chol_inv_logdet(covar)

    def init(self, cnt, sum_x, sum_sq):
        K, D = sum_x.shape
        self.m = sum_x.new_zeros((K, D))
        self.linv = sum_x.new_zeros((K, D, D))
        self.ld = sum_x.new_zeros((K,))
        self.derive(torch.nonzero(cnt > 0)[:, 0], cnt, sum_x, sum_sq)

    def post(self, x, cnt):
        D = x.shape[-1]
        delta = x - self.m
        z = torch.zeros_like(delta)
        for j in range(D):  # z_i = sum_j<=i L^-1[i, j] delta_j (zeros above)
            z = z + self.linv[:, :, j] * delta[:, j, None]
        maha = torch.zeros_like(self.ld)
        for i in range(D):
            maha = maha + z[:, i] * z[:, i]
        v = self.dof(cnt, D)
        return ((self.cterms[cnt.long()] - 0.5 * self.ld)
                - ((v + D) / 2.0) * torch.log1p(maha / v))


def full_chain_inputs(X, log_prior, noise, k_old, stats, prior, alpha, K,
                      lms=1.0, temp=1.0, use_argmax=False) -> tuple:
    """The arguments of :func:`full_chain_plain` and of K11's launch from
    :func:`item_chain`'s: the items, the statistics, the prior's terms (k0
    m0 [D], S_0 + k0 m0 m0^T [D, D], the count terms of
    :func:`full_count_terms`, k0, v0) and the options."""
    n, D = X.shape
    if noise is None:
        if not use_argmax:
            raise ValueError("noise is required unless use_argmax")
        noise = X.new_zeros((n, K))
    k0, v0 = float(prior.k_0), float(prior.v_0)
    m0 = prior.m_0
    terms = (prior.k_0 * m0,
             prior.S_0 + prior.k_0 * (m0[:, None] * m0[None, :]),
             full_count_terms(v0, D, int(stats.counts.sum()) + n, X.dtype,
                              X.device), k0, v0)
    data = tuple(t.contiguous() for t in (X, log_prior, noise, k_old,
                                          *stats))
    return (*data, terms, float(temp), float(alpha), int(K), float(lms),
            bool(use_argmax))


def full_chain_plain(X, log_prior, noise, k_old, counts, sum_x, sum_sq,
                     terms, temp, alpha, K, lms, use_argmax):
    """Plain PyTorch version of K11, an item at a time: the delete (and
    the column's re-derivation, if it keeps members), the scores of every
    column, the draw, the add and the drawn column's re-derivation.
    Returns (ks [n] int32, the final SuffStats)."""
    cols = FullCols(*terms)
    cnt = counts.to(X.dtype).clone()
    sum_x, sum_sq = sum_x.clone(), sum_sq.clone()
    cols.init(cnt, sum_x, sum_sq)
    n = X.shape[0]
    ks = torch.empty(n, dtype=torch.int32, device=X.device)
    sq = X[:, :, None] * X[:, None, :]

    def move(k, s, add):
        """Column k takes (add) or gives up item s and is re-derived."""
        cnt[k] += 1.0 if add else -1.0
        if add:
            sum_x[k] += X[s]
            sum_sq[k] += sq[s]
        else:
            sum_x[k] -= X[s]
            sum_sq[k] -= sq[s]
        if cnt[k] > 0:
            cols.derive(k.reshape(1), cnt, sum_x, sum_sq)

    for s, kd in enumerate(k_old.tolist()):
        if kd >= 0:
            move(torch.tensor(kd, device=X.device), s, add=False)
        logits = lms * torch.log(alpha / K + cnt) + torch.where(
            cnt > 0, cols.post(X[s], cnt), log_prior[s])
        k_draw = (torch.argmax(logits) if use_argmax else
                  annealed_gumbel_max(logits, noise[s], temp))
        k_new = canonicalize_new_component(cnt, k_draw)
        ks[s] = k_new.to(torch.int32)
        move(k_new, s, add=True)
    return ks, SuffStats(cnt.to(torch.int32), sum_x, sum_sq)


# K10's plan (csrc/item_chain.cuh): clusters of C CTAs, at least enough
# that a CTA owns at most ITEM_COLS_CTA columns, where the tables and sums
# fit on chip; a column's fit on one scoring thread up to D ITEM_SPLIT_D,
# above it (the diag family only) split over up to _SPLIT threads; a
# scoring warp for every 32 scoring threads of a CTA's share (at most
# ITEM_SCORE_WARPS) and two update warps.  Per family: the tables on chip
# and in device memory (the fixed family's global form recomputes pp
# from the count), the hoisted terms, the prior vectors; both carry two
# running sums (sx, ssq).
ITEM_CLUSTERS = (1, 2, 4, 8, 16)
ITEM_COLS_CTA = 128
ITEM_SCORE_WARPS = 8
ITEM_SPLIT_D = 32
_TABLES = {"fixed": {"smem": 2, "global": 1}, "diag": {"smem": 2, "global": 2}}
_TERMS = {"fixed": 1, "diag": 2}
_PRIOR = {"fixed": 3, "diag": 2}
_SPLIT = {"fixed": 1, "diag": 4}
_SUMS = 2
_LIB_NAME = {"fixed": "fixedvar", "diag": "diag"}  # the C entry points' prefix


class ItemPlan(NamedTuple):
    """How K10 launches: one cluster of ``cluster`` CTAs of ``threads``,
    ``smem`` bytes of dynamic shared memory a CTA; ``tables`` "smem" (the
    columns' tables, terms and running sums on chip) or "global" (in
    device memory)."""

    cluster: int
    threads: int
    tables: str
    smem: int


def item_split(family: str, D: int, K: int, C: int) -> int:
    """K10's scoring threads a column: 1 up to D ITEM_SPLIT_D, else the
    most (up to the family's _SPLIT: the diag family's division and log1p
    a dim are worth a group, the fixed family's three products are not; a
    power of two) that give every column of the largest share a group
    within ITEM_SCORE_WARPS warps."""
    cols, s = -(-K // C), _SPLIT[family] if D > ITEM_SPLIT_D else 1
    while s > 1 and s * cols > 32 * ITEM_SCORE_WARPS:
        s //= 2
    return s


def item_threads(family: str, D: int, K: int, C: int) -> int:
    """K10's block size: a scoring warp for every 32 scoring threads of
    the largest share (at most ITEM_SCORE_WARPS) and two update warps."""
    need = -(-K // C) * item_split(family, D, K, C)
    return 32 * (min(ITEM_SCORE_WARPS, -(-need // 32)) + 2)


def smem_bytes(family: str, D: int, K: int, C: int,
               tables_global: bool) -> int:
    """Dynamic shared memory of a K10 CTA, as the kernel carves it
    (``csrc/item_chain.cuh::smem_words``), with P the largest share of
    columns, W the warps and S the scoring threads a column: the draw's
    entry slots [2, C W] (16 bytes each); on chip the tables [kTables, D,
    P], the running sums [2, D, P] and the terms [kTerms, P]; counts,
    weight terms and two items' noise [4, P]; x and the log prior of three
    items [3, D + 1]; the prior vectors [kPrior, D]; the two update warps'
    logs and fit addends [4, D]; where S > 1 the scoring groups' addends
    [32 (W - 2) / S, D].  K11 (full): :func:`full_smem_bytes`."""
    P = -(-K // C)
    W = item_threads(family, D, K, C) // 32
    S = item_split(family, D, K, C)
    cols = (0 if tables_global else
            ((_TABLES[family]["smem"] + _SUMS) * D + _TERMS[family]) * P)
    groups = 32 * (W - 2) // S * D if S > 1 else 0
    return 4 * (8 * C * W + cols + 4 * P + 3 * (D + 1) + _PRIOR[family] * D
                + 4 * D + groups)


def item_launch_plan(family: str, D: int, K: int, smem_limit: int,
                     max_cluster: int, cluster: int | None = None
                     ) -> ItemPlan:
    """K10's plan under ``smem_limit`` bytes of dynamic shared memory a CTA
    and clusters of at most ``max_cluster`` CTAs (pure Python).  C runs
    from the least that leaves a CTA ITEM_COLS_CTA columns up to the
    largest the card and K allow, and the first that holds the tables and
    sums on chip wins; else the largest C with them in device memory.
    ``cluster`` forces C.  Raises where nothing fits: no smaller plan, no
    fallback."""
    if family not in _TERMS:
        raise ValueError("no K10 item chain for family %r" % (family,))
    if D < 1 or K < 1:
        raise ValueError("no K10 item chain for D=%d, K=%d" % (D, K))
    cap = max(c for c in ITEM_CLUSTERS if c <= max(1, min(max_cluster, K)))
    if cluster is not None:
        if cluster not in ITEM_CLUSTERS or cluster > cap:
            raise ValueError("a cluster of %d CTAs is not schedulable for "
                             "K=%d (at most %d)" % (cluster, K, cap))
        sizes = [cluster]
    else:
        start = next((c for c in ITEM_CLUSTERS
                      if c <= cap and -(-K // c) <= ITEM_COLS_CTA), cap)
        sizes = [c for c in ITEM_CLUSTERS if start <= c <= cap]
    for c, tab_g in [(c, False) for c in sizes] + [(sizes[-1], True)]:
        smem = smem_bytes(family, D, K, c, tab_g)
        if smem <= smem_limit:
            return ItemPlan(c, item_threads(family, D, K, c),
                            "global" if tab_g else "smem", smem)
    raise ValueError("no %s item chain form fits K=%d, D=%d in %d bytes"
                     % (family, K, D, smem_limit))


class FullPlan(NamedTuple):
    """How K11 launches: one cluster of ``cluster`` CTAs of ``threads``,
    ``smem`` bytes of dynamic shared memory a CTA; ``form`` "warp" (D <=
    32: a derivation on one warp, a thread a column scores) or "cta" (the
    CTA derives, a warp a column scores); ``tables`` and ``work`` "smem"
    (on chip) or "global" (device memory) for the columns' tables and the
    CTA form's work area."""

    form: str
    cluster: int
    threads: int
    tables: str
    work: str
    smem: int


def full_col_range(K: int, C: int, r: int) -> tuple:
    """Columns [lo, hi) that CTA r of a C-CTA cluster owns (the kernel's
    split)."""
    return r * K // C, (r + 1) * K // C


def full_threads(D: int, K: int, C: int) -> int:
    """K11's block size: in the warp form a scoring warp for every 32
    columns of the largest share (at most FULL_SCORE_WARPS) and two update
    warps; in the CTA form 1024."""
    if D > FULL_WARP_D:
        return FULL_CTA_THREADS
    cols = -(-K // C)
    return 32 * (min(FULL_SCORE_WARPS, -(-cols // 32)) + 2)


def full_smem_bytes(D: int, K: int, C: int, tables_global: bool,
                    work_global: bool) -> int:
    """Dynamic shared memory of a K11 CTA, as the kernel carves it
    (``csrc/fullcov_item_chain.cu::smem_words``), with P the largest share
    of columns made odd: counts, weight terms and two items' noise [4, P],
    x and the log prior of three items [3, D + 1], on chip the tables (m_n,
    L^-1, log det: [D + D (D + 1)/2 + 1, P]) and the CTA form's work area
    ([D, D] and two vectors; the warp form derives in registers)."""
    T = D * (D + 1) // 2
    P = -(-K // C) | 1
    work = D * D + 2 * D if D > FULL_WARP_D and not work_global else 0
    return 4 * (4 * P + 3 * (D + 1) + (0 if tables_global
                                       else (D + T + 1) * P) + work)


def full_launch_plan(D: int, K: int, smem_limit: int, max_cluster: int,
                     cluster: int | None = None) -> FullPlan:
    """K11's plan under ``smem_limit`` bytes of dynamic shared memory a CTA
    and clusters of at most ``max_cluster`` CTAs (pure Python).  C runs
    from the least that leaves a CTA FULL_COLS_CTA columns up to the
    largest the card and K allow, and the first that holds the tables on
    chip wins; else the largest C with the tables in device memory (and
    the CTA form's work area too if it does not fit).  ``cluster`` forces
    C.  Raises where nothing fits: no smaller plan, no fallback."""
    if not 1 <= D <= FULL_MAX_D:
        raise ValueError("no full item chain form for D=%d (1 to %d)"
                         % (D, FULL_MAX_D))
    cap = max(c for c in FULL_CLUSTERS if c <= max(1, min(max_cluster, K)))
    if cluster is not None:
        if cluster not in FULL_CLUSTERS or cluster > cap:
            raise ValueError("a cluster of %d CTAs is not schedulable for "
                             "K=%d (at most %d)" % (cluster, K, cap))
        sizes = [cluster]
    else:
        start = next((c for c in FULL_CLUSTERS
                      if c <= cap and -(-K // c) <= FULL_COLS_CTA), cap)
        sizes = [c for c in FULL_CLUSTERS if start <= c <= cap]
    form = "warp" if D <= FULL_WARP_D else "cta"
    # (C, tables in device memory, work area in device memory)
    options = [(c, False, False) for c in sizes] + [
        (sizes[-1], True, w) for w in ((False,) if form == "warp"
                                       else (False, True))]
    g = {True: "global", False: "smem"}
    for c, tab_g, work_g in options:
        smem = full_smem_bytes(D, K, c, tab_g, work_g)
        if smem <= smem_limit:
            return FullPlan(form, c, full_threads(D, K, c), g[tab_g],
                            g[work_g], smem)
    raise ValueError("no full item chain form fits K=%d, D=%d in %d bytes"
                     % (K, D, smem_limit))


def launch_plan(family: str, D: int, K: int, smem_limit: int,
                max_cluster: int = 1, cluster: int | None = None):
    """The plan of K10 (an ItemPlan, :func:`item_launch_plan`) or K11
    (family "full": a FullPlan, :func:`full_launch_plan`).  The chain's
    length does not enter: the steps are the items, read from device
    memory."""
    if family == "full":
        return full_launch_plan(D, K, smem_limit, max_cluster, cluster)
    return item_launch_plan(family, D, K, smem_limit, max_cluster, cluster)


@functools.lru_cache(maxsize=None)
def full_card_limits(device_index: int) -> tuple:
    """(the dynamic shared memory a K11 CTA may take, the largest cluster
    the card schedules) of the current card, asked once a device."""
    lib = cuda_lib.library()
    limit = lib.fullcov_items_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "fullcov_items_smem_limit")
    max_cluster = lib.fullcov_items_max_cluster()
    if max_cluster < 0:
        cuda_lib.check(-max_cluster, "fullcov_items_max_cluster")
    return limit, max_cluster


@functools.lru_cache(maxsize=None)
def item_card_limits(family: str, device_index: int) -> tuple:
    """(the dynamic shared memory a K10 CTA may take, the largest cluster
    the card schedules) of the current card for ``family``, asked once a
    device."""
    lib = cuda_lib.library()
    limit = getattr(lib, "%s_items_smem_limit" % _LIB_NAME[family])()
    if limit < 0:
        cuda_lib.check(-limit, "%s_items_smem_limit" % family)
    max_cluster = getattr(lib, "%s_items_max_cluster" % _LIB_NAME[family])()
    if max_cluster < 0:
        cuda_lib.check(-max_cluster, "%s_items_max_cluster" % family)
    return limit, max_cluster


def card_plan(family: str, D: int, K: int, cluster: int | None = None):
    """:func:`launch_plan` under the current card's limits (its opt-in
    shared memory a block less the kernel's static shared memory, and the
    largest cluster it schedules)."""
    dev = torch.cuda.current_device()
    if family == "full":
        return full_launch_plan(D, K, *full_card_limits(dev), cluster)
    return item_launch_plan(family, D, K, *item_card_limits(family, dev),
                            cluster)


def _launch(family, Xe, log_prior_e, gumbel, k_old, counts, sum_xT, sum_sqT,
            terms, temp, alpha, K, lms, use_argmax, probe=None, cluster=None):
    """K10 on the card, on :func:`item_chain_inputs`' [1, ...] tensors:
    the columns' tables and running sums on chip or, where the plan says,
    in device memory (scratch, and the output sums).  ``cluster`` forces
    the plan's C; ``probe`` (int64 [C, W, 2, 8], zeros) takes the probe
    build's cycles a phase (``utils/item_probe.py``)."""
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
    plan = card_plan(family, D, K, cluster)
    glob = plan.tables == "global"
    if probe is not None:
        req(probe, "probe", torch.int64,
            (plan.cluster, plan.threads // 32, 2, 8), dev)
    ks = torch.empty((1, S), dtype=torch.int32, device=dev)
    cnt = torch.empty((1, K), dtype=torch.int32, device=dev)
    sums = torch.empty((1, _SUMS, D, K), dtype=f32, device=dev)
    tab_g = (torch.empty((_TABLES[family]["global"] * D + _TERMS[family]) * K,
                         dtype=f32, device=dev) if glob else None)
    p = cuda_lib.ptr
    head = (p(Xe), p(log_prior_e), p(gumbel), p(k_old), p(counts),
            p(sum_xT), p(sum_sqT))
    tail = (p(tab_g), p(ks), p(cnt), p(sums), p(probe), S, D, K,
            plan.cluster, int(glob), plan.threads, alpha / K, lms, temp)
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
    cuda_lib.count_form("K10", "C%d %s" % (plan.cluster, plan.tables))
    return ks, cnt, sums


def _launch_full(X, log_prior, noise, k_old, counts, sum_x, sum_sq, terms,
                 temp, alpha, K, lms, use_argmax, probe=None, cluster=None):
    """K11 on the card: the statistics are copied once and updated in
    place by the kernel; the columns' tables and the CTA form's work area
    are on chip or, where the plan says, scratch in device memory.
    ``cluster`` forces the plan's C; ``probe`` (int64 [C, 3, 12], zeros)
    takes the probe build's cycles a phase (``utils/item_probe.py``)."""
    global full_launches
    n, D = X.shape
    dev, f32 = X.device, torch.float32
    req = cuda_lib.require
    req(X, "X", f32, (n, D), dev)
    req(log_prior, "log_prior", f32, (n,), dev)
    req(noise, "noise", f32, (n, K), dev)
    req(k_old, "k_old", torch.int32, (n,), dev)
    req(counts, "counts", torch.int32, (K,), dev)
    req(sum_x, "sum_x", f32, (K, D), dev)
    req(sum_sq, "sum_sq", f32, (K, D, D), dev)
    k0m0, snp0, cterms, k0, v0 = terms
    req(k0m0, "k0 m0", f32, (D,), dev)
    req(snp0, "S_0 + k0 m0 m0^T", f32, (D, D), dev)
    req(cterms, "count terms", f32, (cterms.shape[0],), dev)
    plan = card_plan("full", D, K, cluster)
    if probe is not None:
        req(probe, "probe", torch.int64, (plan.cluster, 3, 12), dev)
    ks = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(K, dtype=torch.int32, device=dev)
    sx, ssq = sum_x.clone(), sum_sq.clone()
    tab_g = work_g = None
    if plan.tables == "global":
        tab_g = torch.empty(K * (D + D * (D + 1) // 2 + 1), dtype=f32,
                            device=dev)
    if plan.work == "global":
        work_g = torch.empty((plan.cluster, D * D + 2 * D), dtype=f32,
                             device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().fullcov_items_launch(
        p(X), p(log_prior), p(noise), p(k_old), p(counts), p(k0m0), p(snp0),
        p(cterms), k0, v0, p(sx), p(ssq), p(tab_g), p(work_g), p(ks), p(cnt),
        p(probe), n, D, K, plan.cluster, int(plan.tables == "global"),
        int(plan.work == "global"), plan.threads, alpha / K, lms, temp,
        int(use_argmax), cuda_lib.stream_of(X))
    cuda_lib.check(err, "fullcov_items")
    full_launches += 1
    cuda_lib.count_form("K11", "%s C%d tables %s work %s" % (
        plan.form, plan.cluster, plan.tables, plan.work))
    return ks, SuffStats(cnt, sx, ssq)
