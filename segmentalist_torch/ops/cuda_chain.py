"""Within-utterance fixed-variance assignment chains: kernels K3 and K4 and
their plain versions.

Counterpart of the fixed-variance chains of
``segmentalist_tpu/ops/pallas_chain.py`` (``fixedvar_chain`` and
``bigram_fixedvar_chain``, both with ``stats_T=True``).  Each utterance's
new segments are assigned in order, conditioning on the statistics the
previous ones updated (reference ``fbgmm.py:422-463`` via
``unigram_acoustic_wordseg.py:339-349``, and
``bigram_acoustic_wordseg.py:332-384`` for the bigram weights):
Gumbel-max (or argmax) over K, the first-empty birth rule, and an exact
select of the re-derived column.  K3 weighs the components with the
Dirichlet term ``lms log(alpha/K + n_k)``, K4 with the smoothed bigram LM
conditioned on the previous segment's draw.  The plain versions follow the
kernels' math (``pallas_chain.py:240-307``, ``:463-555``) step for step,
with the same operation order, so on shared noise they sample the same
chains.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cuda_lib
from .random import annealed_gumbel_max
from .stats import canonicalize_new_component

_LOG_2PI = math.log(2.0 * math.pi)

launches = 0         # K3 launches since the last reset
bigram_launches = 0  # K4 launches since the last reset


def fixedvar_chain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, var,
                   var_0, mu_0, temp, alpha: float, K: int, lms: float = 1.0,
                   use_argmax: bool = False):
    """Sequential within-utterance assignment chains, batched over
    utterances (kernel K3).

    embeds [B, S] int32 segment embedding ids (-1 = pad); Xe [B, S, D] their
    vectors; log_prior_e [B, S] their prior log densities; gumbel [B, S, K]
    noise (ignored for ``use_argmax``); counts [B, K] int32 and sum_xT
    [B, D, K] the leave-one-utterance-out statistics; var / var_0 / mu_0
    [D] the fixed-variance prior; temp a Python float.

    Returns ks [B, S] int32, the sampled component of each segment (-1 pads).
    """
    prec = 1.0 / var
    prec0 = 1.0 / var_0
    p0m0 = prec0 * mu_0
    args = (embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0,
            p0m0, float(temp), float(alpha), int(K), float(lms),
            bool(use_argmax))
    if cuda_lib.use_kernel(Xe):
        return _launch(*args)
    return fixedvar_chain_plain(*args)


def bigram_constants(alpha_a: float, b_smooth: float, intrp_lambda: float,
                     K: int) -> tuple:
    """(a/K, a, b/K, b, lam, 1 - lam): the LM constants as the JAX kernel
    forms them (``pallas_chain.py:443-446``), in double precision; the
    kernel gets each rounded once to float32, exactly what a float32
    tensor operation rounds the same Python float to."""
    a, b, lam = float(alpha_a), float(b_smooth), float(intrp_lambda)
    return (a / K, a, b / K, b, lam, 1.0 - lam)


def bigram_fixedvar_chain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                          var, var_0, mu_0, temp, uni_lo, big_table, corr_j,
                          corr_i, alpha_a: float, intrp_lambda: float,
                          b_smooth: float, K: int, lms: float = 1.0):
    """Bigram-conditioned assignment chains (kernel K4): the inputs of
    :func:`fixedvar_chain` (always Gumbel-max) plus ``uni_lo`` [B, K] int32
    leave-one-utterance-out unigram counts, ``big_table`` [K, K] int32 global
    bigram counts and ``corr_j`` / ``corr_i`` [B, S] int32 the utterance's
    own old (prev, cur) pairs, removed from the table rows on the fly.  The
    LM weight of a segment is

        lms * log(lam * uni_prob
                  + (1 - lam) * (row_j - corr + b/K) / (c_j + b))

    given the previous valid segment's draw j, and the unigram weight for
    the first.  Every valid old pair must be counted in ``big_table`` or the
    weight goes NaN (the JAX kernel's caveat, ``pallas_chain.py:383-385``).

    Returns ks [B, S] int32 (-1 pads).
    """
    prec = 1.0 / var
    prec0 = 1.0 / var_0
    p0m0 = prec0 * mu_0
    args = (embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0,
            p0m0, float(temp), uni_lo, big_table, corr_j, corr_i,
            bigram_constants(alpha_a, b_smooth, intrp_lambda, K), int(K),
            float(lms))
    if cuda_lib.use_kernel(Xe):
        return _launch_bigram(*args)
    return bigram_fixedvar_chain_plain(*args)


def _derive(prec, prec0, p0m0, cnt, sx):
    prec_n = prec0 + cnt * prec
    return (p0m0 + prec * sx) / prec_n, prec_n * prec / (prec_n + prec)


def sum_d(terms):
    """sum over axis 1, accumulated in ascending d from 0 (the kernels'
    order; the terms themselves are formed elementwise, all d at once)."""
    acc = torch.zeros_like(terms[:, 0])
    for d in range(terms.shape[1]):
        acc = acc + terms[:, d]
    return acc


def _sum_log_d(pp):
    """sum over axis 1 of log(pp), accumulated in ascending d (the
    kernel's order); non-positive entries count as log(1) = 0."""
    return sum_d(torch.log(torch.where(pp > 0, pp, 1.0)))


class FixedVarCols:
    """The fixed-variance column model of the plain chains (K3 / K4 and
    K10's fixed policy, ``csrc/fixedvar_chain.cu``): per column mu and pp
    [B, D, K] from the count and sx, and lpp [B, K] = sum_d log pp; the fit
    is ``(c0 + 0.5 lpp) - 0.5 sum_d (x_d - mu[d])^2 pp[d]`` in ascending
    d.  ``init`` derives every column, ``update`` the columns (b, k)."""

    def __init__(self, prec, prec0, p0m0):
        self.prec, self.prec0, self.p0m0 = prec, prec0, p0m0

    def init(self, cnt, sums):
        self.mu, self.pp = _derive(self.prec[:, None], self.prec0[:, None],
                                   self.p0m0[:, None], cnt[:, None, :],
                                   sums[0])
        self.lpp = _sum_log_d(self.pp)

    def post(self, x, cnt):
        dl = x[:, :, None] - self.mu
        maha = sum_d(dl * dl * self.pp)
        return (-0.5 * x.shape[-1] * _LOG_2PI + 0.5 * self.lpp) - 0.5 * maha

    def update(self, b, k, c_new, sums_k):
        mu_k, pp_k = _derive(self.prec, self.prec0, self.p0m0,
                             c_new[:, None], sums_k[0])
        self.mu[b, :, k] = mu_k
        self.pp[b, :, k] = pp_k
        self.lpp[b, k] = _sum_log_d(pp_k)


def _chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sums, cols, temp,
                 use_argmax, weights, k_old=None):
    """The chain loop of every plain chain version (K3 / K4, K6 / K7 and
    K10), all utterances advancing one segment per step; utterances past
    their last segment see ``embeds < 0`` and change nothing.

    ``sums`` are the running sums [B, D, K] (sx, and ssq where given),
    each item adding x (and x x); ``cols`` is the column model (``init``,
    ``post``, ``update``: :class:`FixedVarCols`,
    ``cuda_diag_chain.DiagCols``); ``weights(cnt, j_prev)`` gives the [B,
    K] mixture-weight term of a step from the running counts [B, K] and the
    previous valid segment's draw [B] (-1 before the first).  ``k_old``
    [B, S] (K10's delete): before step s is scored its item leaves column
    ``k_old[:, s]`` where that is >= 0, by ``sum - x`` (the JAX package's
    ``sum + (-1) x``, the same bits).  Returns (ks [B, S] int32, -1 pads;
    the final counts [B, K] and sums)."""
    B, S = embeds.shape
    cnt = counts.to(Xe.dtype).clone()                           # [B, K]
    sums = [t.clone() for t in sums]                            # [B, D, K]
    cols.init(cnt, sums)
    ks = torch.full((B, S), -1, dtype=torch.int32, device=Xe.device)
    j_prev = torch.full((B,), -1, dtype=torch.long, device=Xe.device)
    steps = torch.arange(1, S + 1, device=Xe.device)
    n_steps = int(torch.where(embeds >= 0, steps, 0).amax()) if S else 0
    rows = torch.arange(B, device=Xe.device)

    def move(sel, k, x, add):
        """Columns k of the rows ``sel`` take (add) or give up x."""
        b = rows[sel]
        k, xo = k[b], x[b]
        cnt[b, k] += 1.0 if add else -1.0
        for r, t in enumerate(sums):
            term = xo if r == 0 else xo * xo
            if add:
                t[b, :, k] += term
            else:
                t[b, :, k] -= term
        cols.update(b, k, cnt[b, k], [t[b, :, k] for t in sums])

    for s in range(n_steps):
        ok = embeds[:, s] >= 0
        x = Xe[:, s, :]
        if k_old is not None:
            kd = k_old[:, s].long()
            move(ok & (kd >= 0), kd.clamp_min(0), x, add=False)
        logits = weights(cnt, j_prev) + torch.where(
            cnt > 0, cols.post(x, cnt), log_prior_e[:, s, None])
        k_draw = (torch.argmax(logits, dim=-1) if use_argmax else
                  annealed_gumbel_max(logits, gumbel[:, s], temp))
        k_new = canonicalize_new_component(cnt, k_draw)
        ks[:, s] = torch.where(ok, k_new, -1).to(torch.int32)
        j_prev = torch.where(ok, k_new, j_prev)
        move(ok, k_new, x, add=True)
    return ks, cnt, sums


def fixedvar_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                         prec, prec0, p0m0, temp, alpha, K, lms, use_argmax):
    """Plain PyTorch version of K3."""
    def weights(cnt, j_prev):
        return lms * torch.log(alpha / K + cnt)

    return _chain_plain(embeds, Xe, log_prior_e, gumbel, counts, (sum_xT,),
                        FixedVarCols(prec, prec0, p0m0), temp, use_argmax,
                        weights)[0]


def bigram_lm_weights(uni_lo, big_table, corr_j, corr_i, consts, K, lms,
                      dtype):
    """The bigram-LM weight term of the plain K4 and K7 chains (the
    kernels' ``csrc/bigram_lm.cuh``), in the kernels' operation order
    (``consts`` from :func:`bigram_constants`).  Returns ``weights(cnt,
    j_prev)`` -> [B, K] for the previous valid segment's draw j_prev [B]
    (-1 before the first: the unigram weights)."""
    a_K, a, b_K, b, lam, one_m_lam = consts
    B, S = corr_j.shape
    u = uni_lo.to(dtype)
    uni_den = uni_lo.sum(-1, keepdim=True).to(dtype) + a      # [B, 1]
    uni_w = lms * (torch.log(u + a_K) - torch.log(uni_den))
    own = (corr_j >= 0) & (corr_i >= 0)

    def weights(cnt, j_prev):
        js = j_prev.clamp_min(0)
        hit = own & (corr_j == js[:, None])                    # [B, S]
        corr = torch.zeros((B, K + 1), dtype=torch.int32, device=u.device)
        corr.scatter_add_(1, torch.where(hit, corr_i, K).long(),
                          torch.ones_like(corr_i, dtype=torch.int32))
        row = (big_table[js] - corr[:, :K]).to(dtype)
        uni_j = u.gather(1, js[:, None])
        p = lam * ((u + a_K) / uni_den) \
            + (one_m_lam * (row + b_K)) / (uni_j + b)
        return torch.where((j_prev >= 0)[:, None], lms * torch.log(p), uni_w)

    return weights


def bigram_fixedvar_chain_plain(embeds, Xe, log_prior_e, gumbel, counts,
                                sum_xT, prec, prec0, p0m0, temp, uni_lo,
                                big_table, corr_j, corr_i, consts, K, lms):
    """Plain PyTorch version of K4 (``consts`` from
    :func:`bigram_constants`): the LM weights of :func:`bigram_lm_weights`,
    the rest as K3."""
    weights = bigram_lm_weights(uni_lo, big_table, corr_j, corr_i, consts,
                                K, lms, Xe.dtype)
    return _chain_plain(embeds, Xe, log_prior_e, gumbel, counts, (sum_xT,),
                        FixedVarCols(prec, prec0, p0m0), temp, False,
                        weights)[0]


class ChainPlan(NamedTuple):
    """How a chain of the diagonal family (K3 / K4, K6 / K7) launches: one
    CTA of ``threads`` an utterance, with ``smem`` bytes of dynamic shared
    memory; ``form`` "smem" keeps the tables and column arrays in shared
    memory, "global" in device memory."""

    form: str
    threads: int
    smem: int


def pick_form(smem_of, K: int, S: int, smem_limit: int,
              what: str) -> ChainPlan:
    """The first form of ("smem", "global") whose shared memory
    ``smem_of(global_tables)`` fits ``smem_limit`` bytes, with a thread a
    column up to 1024; raises if neither fits or S is too long."""
    if S >= 1 << 15:
        raise ValueError("%s chains take fewer than 32768 segments" % what)
    threads = min(1024, 32 * max(1, -(-K // 32)))
    for form in ("smem", "global"):
        smem = smem_of(form == "global")
        if smem <= smem_limit:
            return ChainPlan(form, threads, smem)
    raise ValueError("no %s chain form fits K=%d, S=%d" % (what, K, S))


# K3 / K4's tables: mu and pp in the smem form; mu alone in the global
# form, which recomputes pp from the count.
TABLES = {"smem": 2, "global": 1}
N_COL_ARRAYS = 5  # the global form's [B, 5, K] column arrays


def smem_bytes(global_tables: bool, bigram: bool, D: int, S: int,
               K: int) -> int:
    """Dynamic shared memory of K3 / K4's CTA, as the kernel reserves it
    (``csrc/diag_family_chain.cuh::smem_words`` of the form's policy).  The
    smem form: per column its tables, cnt, the hoisted term, the weight
    term and the touched slot (K4: and its old-pair range) and a
    double-buffered noise value.  Both forms: x and the log prior
    [3, D + 1]; prec, prec0, p0m0, the updated column's logs and its
    running sums [5, D]; the valid steps [S]; K4: the old pairs [2, S]."""
    per_col = TABLES["smem"] * D + (5 if bigram else 4) + 2
    words = ((0 if global_tables else per_col * K) + 3 * (D + 1) + 5 * D
             + S + (2 * S if bigram else 0))
    return 4 * words


def launch_plan(D: int, K: int, S: int, bigram: bool,
                smem_limit: int) -> ChainPlan:
    """The form of K3 / K4 for D dims, K columns and S segments (pure
    Python): "smem" where the tables fit the ``smem_limit`` bytes of
    dynamic shared memory a CTA may take, else "global".  Raises if
    neither fits."""
    return pick_form(lambda g: smem_bytes(g, bigram, D, S, K), K, S,
                     smem_limit, "fixed-variance")


def card_plan(D: int, K: int, S: int, bigram: bool) -> ChainPlan:
    """:func:`launch_plan` under the current card's limit: its opt-in
    shared memory a block less the kernel's static shared memory, as the
    kernel library reads them."""
    limit = cuda_lib.library().fixedvar_chain_smem_limit()
    if limit < 0:
        cuda_lib.check(-limit, "fixedvar_chain_smem_limit")
    return launch_plan(D, K, S, bigram, limit)


def _outputs(plan, B, S, D, K, dev):
    """ks and the kernel's device-memory scratch: the touched-column table
    [B, S, D] (a slot a step) and, for the global form only, the tables
    [B, tables, D, K] and the column arrays [B, 5, K]."""
    f32 = torch.float32
    ks = torch.empty((B, S), dtype=torch.int32, device=dev)
    touched = torch.empty((B, S, D), dtype=f32, device=dev)
    glob = ((torch.empty((B, TABLES["global"], D, K), dtype=f32,
                         device=dev),
             torch.empty((B, N_COL_ARRAYS, K), dtype=f32, device=dev))
            if plan.form == "global" else (None, None))
    return ks, touched, glob


def _check_chain_inputs(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                        prec, prec0, p0m0, K):
    B, S = embeds.shape
    D = Xe.shape[-1]
    dev, f32 = Xe.device, torch.float32
    req = cuda_lib.require
    req(embeds, "embeds", torch.int32, (B, S), dev)
    req(Xe, "Xe", f32, (B, S, D), dev)
    req(log_prior_e, "log_prior_e", f32, (B, S), dev)
    req(gumbel, "gumbel", f32, (B, S, K), dev)
    req(counts, "counts", torch.int32, (B, K), dev)
    req(sum_xT, "sum_xT", f32, (B, D, K), dev)
    for name, t in (("prec", prec), ("prec0", prec0), ("p0m0", p0m0)):
        req(t, name, f32, (D,), dev)
    return B, S, D, dev


def _launch(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0,
            p0m0, temp, alpha, K, lms, use_argmax):
    global launches
    B, S, D, dev = _check_chain_inputs(embeds, Xe, log_prior_e, gumbel,
                                       counts, sum_xT, prec, prec0, p0m0, K)
    plan = card_plan(D, K, S, False)
    ks, touched, glob = _outputs(plan, B, S, D, K, dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().fixedvar_chain_launch(
        p(embeds), p(Xe), p(log_prior_e), p(gumbel), p(counts), p(sum_xT),
        p(prec), p(prec0), p(p0m0), p(touched), *(p(t) for t in glob),
        p(ks), B, S, D, K, int(plan.form == "global"), plan.threads, alpha / K, lms,
        temp, -0.5 * D * _LOG_2PI, int(use_argmax), cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "fixedvar_chain")
    launches += 1
    cuda_lib.count_form("K3", plan.form)
    return ks


def _launch_bigram(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec,
                   prec0, p0m0, temp, uni_lo, big_table, corr_j, corr_i,
                   consts, K, lms):
    global bigram_launches
    B, S, D, dev = _check_chain_inputs(embeds, Xe, log_prior_e, gumbel,
                                       counts, sum_xT, prec, prec0, p0m0, K)
    req = cuda_lib.require
    req(uni_lo, "uni_lo", torch.int32, (B, K), dev)
    req(big_table, "big_table", torch.int32, (K, K), dev)
    req(corr_j, "corr_j", torch.int32, (B, S), dev)
    req(corr_i, "corr_i", torch.int32, (B, S), dev)
    plan = card_plan(D, K, S, True)
    ks, touched, glob = _outputs(plan, B, S, D, K, dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().bigram_fixedvar_chain_launch(
        p(embeds), p(Xe), p(log_prior_e), p(gumbel), p(counts), p(sum_xT),
        p(prec), p(prec0), p(p0m0), p(uni_lo), p(big_table), p(corr_j),
        p(corr_i), p(touched), *(p(t) for t in glob), p(ks), B, S, D, K,
        int(plan.form == "global"), plan.threads, *consts, lms, temp,
        -0.5 * D * _LOG_2PI, cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "bigram_fixedvar_chain")
    bigram_launches += 1
    cuda_lib.count_form("K4", plan.form)
    return ks
