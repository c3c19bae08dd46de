"""Within-utterance fixed-variance assignment chain: kernel K3 and its plain
version.

Counterpart of the fixed-variance part of
``segmentalist_tpu/ops/pallas_chain.py`` (``fixedvar_chain`` with
``stats_T=True``).  Each utterance's new segments are assigned in order,
conditioning on the statistics the previous ones updated (reference
``fbgmm.py:422-463`` via ``unigram_acoustic_wordseg.py:339-349``):
Gumbel-max (or argmax) over K, the first-empty birth rule, and an exact
select of the re-derived column.  The plain version follows the kernel's
math (``pallas_chain.py:240-307``) step for step, with the same operation
order, so on shared noise both sample the same chains.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .random import annealed_gumbel_max
from .stats import canonicalize_new_component

_LOG_2PI = math.log(2.0 * math.pi)

launches = 0  # kernel launches since the last reset


def fixedvar_chain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, var,
                   var_0, mu_0, temp, alpha: float, K: int, lms: float = 1.0,
                   use_argmax: bool = False):
    """Sequential within-utterance assignment chains, batched over
    utterances.

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


def _derive(prec, prec0, p0m0, cnt, sx):
    prec_n = prec0 + cnt * prec
    return (p0m0 + prec * sx) / prec_n, prec_n * prec / (prec_n + prec)


def _sum_log_d(pp):
    """sum over axis 1 of log(pp), accumulated in ascending d (the
    kernel's order); non-positive entries count as log(1) = 0."""
    acc = torch.zeros_like(pp[:, 0])
    for d in range(pp.shape[1]):
        r = pp[:, d]
        acc = acc + torch.log(torch.where(r > 0, r, 1.0))
    return acc


def fixedvar_chain_plain(embeds, Xe, log_prior_e, gumbel, counts, sum_xT,
                         prec, prec0, p0m0, temp, alpha, K, lms, use_argmax):
    """Plain PyTorch version of K3, all utterances advancing one segment
    per step; utterances past their last segment see ``embeds < 0`` and
    change nothing."""
    B, S = embeds.shape
    D = Xe.shape[-1]
    pc, p0c, pmc = prec[:, None], prec0[:, None], p0m0[:, None]  # [D, 1]
    cnt = counts.to(Xe.dtype).clone()                           # [B, K]
    sx = sum_xT.clone()                                         # [B, D, K]
    mu, pp = _derive(pc, p0c, pmc, cnt[:, None, :], sx)
    lpp = _sum_log_d(pp)                                        # [B, K]
    ks = torch.full((B, S), -1, dtype=torch.int32, device=Xe.device)
    steps = torch.arange(1, S + 1, device=Xe.device)
    n_steps = int(torch.where(embeds >= 0, steps, 0).amax()) if S else 0
    c0 = -0.5 * D * _LOG_2PI
    rows = torch.arange(B, device=Xe.device)
    for s in range(n_steps):
        ok = embeds[:, s] >= 0
        x = Xe[:, s, :]
        maha = torch.zeros_like(cnt)
        for d in range(D):
            dl = x[:, d, None] - mu[:, d, :]
            maha = maha + dl * dl * pp[:, d, :]
        post = (c0 + 0.5 * lpp) - 0.5 * maha
        w = lms * torch.log(alpha / K + cnt)
        logits = w + torch.where(cnt > 0, post, log_prior_e[:, s, None])
        k_draw = (torch.argmax(logits, dim=-1) if use_argmax else
                  annealed_gumbel_max(logits, gumbel[:, s], temp))
        k_new = canonicalize_new_component(cnt, k_draw)
        ks[:, s] = torch.where(ok, k_new, -1).to(torch.int32)
        b, k = rows[ok], k_new[ok]
        cnt[b, k] += 1.0
        sx[b, :, k] += x[ok]
        mu_k, pp_k = _derive(prec, prec0, p0m0, cnt[b, k][:, None],
                             sx[b, :, k])
        mu[b, :, k] = mu_k
        pp[b, :, k] = pp_k
        lpp[b, k] = _sum_log_d(pp_k)
    return ks


def _launch(embeds, Xe, log_prior_e, gumbel, counts, sum_xT, prec, prec0,
            p0m0, temp, alpha, K, lms, use_argmax):
    global launches
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
    cnt_s = torch.empty((B, K), dtype=f32, device=dev)
    lpp_s = torch.empty((B, K), dtype=f32, device=dev)
    sumx_s, mu_s, pp_s = (torch.empty((B, D, K), dtype=f32, device=dev)
                          for _ in range(3))
    ks = torch.empty((B, S), dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    err = cuda_lib.library().fixedvar_chain_launch(
        p(embeds), p(Xe), p(log_prior_e), p(gumbel), p(counts), p(sum_xT),
        p(prec), p(prec0), p(p0m0), p(cnt_s), p(sumx_s), p(mu_s), p(pp_s),
        p(lpp_s), p(ks), B, S, D, K, alpha / K, lms, temp,
        -0.5 * D * _LOG_2PI, int(use_argmax), cuda_lib.stream_of(Xe))
    cuda_lib.check(err, "fixedvar_chain")
    launches += 1
    return ks
