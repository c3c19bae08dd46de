"""Plain reference of the bigram blocked Gibbs sampler, and the judge that
holds a captured sweep of the program to it.

The model (kamperh/segmentalist ``bigram_acoustic_wordseg.py`` with the
smoothed bigram LM ``BigramSmoothLM``, ``bigram_lms.py:17-114``): the
acoustic components of :mod:`.unigram`, and in place of the Dirichlet
weights an LM over each utterance's transcript, the components of its
segments in order (a segment without an embedding, or unassigned, is
skipped and the context carried over it).  With unigram counts ``c`` (``N``
tokens) and bigram counts ``c_jk``:

    p_uni(k)     = (c_k + a / K) / (N + a)
    p_big(k | j) = (c_jk + b / K) / (c_j + b)
    p(k | j)     = lam p_uni(k) + (1 - lam) p_big(k | j)

A block step (blocked as ``segmentalist_torch/segmenters/bigram.py``
states it):

1. leave each utterance of the block out of the acoustic statistics and
   of the LM's counts (its transcript's tokens and pairs);
2. score every candidate span as :mod:`.unigram` does, with the LM's
   leave-out unigram weights ``lms log p_uni(k)``;
3. draw the boundaries (the DP of :mod:`.common`);
4. draw each utterance's new segments' components left to right, the
   first against ``lms log p_uni``, each later one against ``lms log
   p(k | j)`` for the draw j of the segment before it
   (``gibbs_sample_inside_loop_i_embed``, ``:332-384``): the acoustic
   statistics take each draw as the chain goes, the LM's leave-out counts
   stay as they are until the utterance ends (the reference re-adds an
   utterance's counts after the whole utterance, ``:496``);
5. decollide and merge as :mod:`.unigram` does; the LM then counts the
   block's new transcripts.

The judge follows the program block by block from its own state, as
:mod:`.unigram`'s does; the LM's counts are rebuilt before every block
from every utterance's transcript in that state, never taken from the
program.  It makes :mod:`.unigram`'s readings and one more:

* ``lpz_err``: the sweep record's last ``log_prob_z`` against this
  reference's replay of the final transcripts (utterance by utterance,
  each token scored against the counts of the tokens before it, then
  counted; reference ``log_prob_z``, ``:287-305``), relative to
  ``max(|replay|, 1)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import common, unigram
from .unigram import Block, Model, new_segments, stats_readings

READINGS = unigram.READINGS + ("lpz_err",)


# ------------------------------------------------------------------ the LM

def transcript(t: common.Tables, u: int, assign, bounds_row) -> list:
    """Utterance u's transcript: its segments' components in order, the
    segments without an embedding or a component skipped."""
    return [int(assign[e]) for e in t.embeds(u, bounds_row)
            if e >= 0 and assign[e] >= 0]


def all_transcripts(t: common.Tables, assign, bounds) -> list:
    """Every utterance's transcript in the state ``assign`` / ``bounds``."""
    return [transcript(t, u, assign, bounds[u]) for u in range(t.U)]


def lm_counts(transcripts, K: int):
    """(unigram [K], bigram [K, K]) int64 counts of the transcripts: every
    token, and every pair of consecutive tokens of one transcript."""
    uni = np.zeros(K, dtype=np.int64)
    big = np.zeros((K, K), dtype=np.int64)
    for tr in transcripts:
        tr = np.asarray(tr, dtype=np.int64)
        np.add.at(uni, tr, 1)
        np.add.at(big, (tr[:-1], tr[1:]), 1)
    return uni, big


def own_pairs(tr) -> dict:
    """{j: {k: count}} of the consecutive pairs (j, k) of one
    transcript."""
    out = {}
    for j, k in zip(tr[:-1], tr[1:]):
        row = out.setdefault(j, {})
        row[k] = row.get(k, 0) + 1
    return out


class LM:
    """The configuration's LM (``cfg["lm"]``, the mixture's ``lms``)."""

    def __init__(self, cfg: dict, K: int):
        p = cfg["lm"]
        self.lam, self.a, self.b = p["intrp_lambda"], p["a"], p["b"]
        self.K, self.lms = K, cfg["lms"]

    def log_uni(self, uni):
        """``lms log p_uni`` [.., K] of unigram counts [.., K] (a float
        tensor, in its dtype)."""
        return self.lms * (torch.log(uni + self.a / self.K)
                           - torch.log(uni.sum(-1, keepdim=True) + self.a))

    def p_cond(self, uni, big_row, c_j):
        """``p(k | j)`` [.., K] of unigram counts [.., K], the bigram row
        of j [.., K] and j's unigram count [..]."""
        p_uni = (uni + self.a / self.K) / (uni.sum(-1, keepdim=True)
                                           + self.a)
        p_big = (big_row + self.b / self.K) / (c_j[..., None] + self.b)
        return self.lam * p_uni + (1.0 - self.lam) * p_big

    def log_prob_z(self, transcripts, dtype=torch.float64) -> float:
        """The corpus log P(z), replayed: each token scored against the
        counts of every token before it (this utterance's earlier ones
        included), then counted; the sum of the logs formed in ``dtype``."""
        K = self.K
        uni = np.zeros(K, dtype=np.int64)
        big = {}
        n = 0
        rows = []   # per token (c_i, N, c_ji, c_j, has a j)
        for tr in transcripts:
            j = -1
            for i in tr:
                if j >= 0:
                    rows.append((int(uni[i]), n, big.get((j, i), 0),
                                 int(uni[j]), 1))
                    big[j, i] = big.get((j, i), 0) + 1
                else:
                    rows.append((int(uni[i]), n, 0, 0, 0))
                uni[i] += 1
                n += 1
                j = i
        if not rows:
            return 0.0
        c_i, N, c_ji, c_j, has = torch.tensor(rows, dtype=dtype).T
        p_uni = (c_i + self.a / K) / (N + self.a)
        p_big = (c_ji + self.b / K) / (c_j + self.b)
        p = torch.where(has > 0, self.lam * p_uni + (1.0 - self.lam) * p_big,
                        p_uni)
        return float(torch.log(p).sum())


class LMBlock:
    """The LM at a block's start: the counts of every utterance's
    ``transcripts``, and the leave-out of each of the block's ``rows``
    (utterance ids: its own tokens and pairs removed), in ``dtype`` on
    ``device``."""

    def __init__(self, lm: LM, transcripts, rows, device, dtype):
        K = lm.K
        self.lm = lm
        uni, big = lm_counts(transcripts, K)
        lo = np.zeros((len(rows), K), dtype=np.int64)
        for b, u in enumerate(rows):
            lo[b] = uni - np.bincount(np.asarray(transcripts[u],
                                                 dtype=np.int64),
                                      minlength=K)
        self.uni_lo = torch.as_tensor(lo, device=device).to(dtype)  # [B, K]
        self.big = torch.as_tensor(big, device=device).to(dtype)    # [K, K]
        self.own_pairs = [own_pairs(transcripts[u]) for u in rows]

    @classmethod
    def of_block(cls, lm: LM, m: Model, blk: Block, bounds):
        """The LM of the state ``blk.assign`` / ``bounds``."""
        return cls(lm, all_transcripts(m.t, blk.assign, bounds), blk.idx,
                   m.device, m.dtype)

    def log_uni(self):
        """[B, K] the rows' leave-out unigram weights (the scores' and a
        chain's first draw's)."""
        return self.lm.log_uni(self.uni_lo)

    def weights(self, j_prev):
        """[B, K] each row's weights given the draw ``j_prev`` [B] of its
        previous segment (-1: none, the unigram weights)."""
        w = self.log_uni()
        rows = [b for b in range(len(j_prev)) if j_prev[b] >= 0]
        if not rows:
            return w
        js = [int(j_prev[b]) for b in rows]
        big_row = self.big[js].clone()
        for r, (b, j) in enumerate(zip(rows, js)):
            for k, c in self.own_pairs[b].get(j, {}).items():
                big_row[r, k] -= c
        rb = torch.tensor(rows, device=w.device)
        u = self.uni_lo[rb]
        c_j = u.gather(1, torch.tensor(js, device=w.device)[:, None])[:, 0]
        w[rb] = self.lm.lms * torch.log(self.lm.p_cond(u, big_row, c_j))
        return w


# -------------------------------------------------------------- one block

def block_scores(m: Model, blk: Block, w):
    """[B, N_max, W] reference candidate scores of the block under the
    mixture weights ``w`` [B, K] (:func:`.unigram.block_scores` with the
    LM's weights in place of the Dirichlet ones)."""
    t, cfg = m.t, m.cfg
    B, N_max, W = len(blk.idx), t.N_max, t.W
    ids = torch.as_tensor(t.seg_ids[blk.idx], device=m.device)      # [B,N,W]
    durs = torch.as_tensor(t.seg_durs[blk.idx], device=m.device).to(m.dtype)
    rows = m.X[ids.clamp_min(0).reshape(-1)]                        # [B*M, D]
    post = m.post_all(blk.g, rows).reshape(B, N_max * W, m.K)
    prior = m.fam.log_prior(rows).reshape(B, N_max * W)
    x = rows.reshape(B, N_max * W, -1)
    pairs = [(b, k) for b in range(B) for k in blk.touched[b]]
    if pairs:   # the touched components' leave-out columns
        bs = torch.tensor([b for b, _ in pairs], device=m.device)
        ks = torch.tensor([k for _, k in pairs], device=m.device)
        n, sx, ssq = blk.pair_stats(m, pairs)
        lo = m.fam.logpdf_many(m.params(n, sx, ssq), x[bs])
        post[bs, :, ks] = torch.where((n > 0)[:, None], lo, prior[bs])
    lo = blk.lo_counts
    logits = w[:, None, :] + torch.where(lo[:, None, :] > 0, post,
                                         prior[..., None])
    margs = torch.logsumexp(logits, dim=-1).reshape(B, N_max, W)
    scale = torch.where(torch.isnan(durs), 0.0, durs) ** cfg["time_power_term"]
    scores = margs * scale + cfg["wip"]
    bad = (ids < 0) | torch.isnan(durs)
    return torch.where(bad, common.NEG_INF, scores)


def chain(m: Model, blk: Block, lmb: LMBlock, E, noise, temp: float,
          ks=None):
    """The block's bigram assignment chains over the new segments E [B, S]
    (noise [B, >= S, K]), :func:`.unigram.chain` with the LM's weights
    given each row's previous draw.  With ``ks`` [B, S] (a run's draws)
    the judge: returns (per-row widest gap, ks as given, bad draws), the
    context following the run's draws; without, the sampler: (zeros, its
    own draws, 0)."""
    B, S = E.shape
    K = m.K
    dev = m.device
    Et = torch.as_tensor(E, device=dev)
    xs = m.X[Et.clamp_min(0)]                                       # [B,S,D]
    base = m.post_all(blk.g, xs.reshape(B * S, -1)).reshape(B, S, K)
    prior = m.fam.log_prior(xs)                                     # [B, S]
    g_n = blk.g[0]
    NS = max(len(t) for t in blk.touched) + S
    slot_k = np.full((B, NS), -1, dtype=np.int64)
    where = [dict() for _ in range(B)]
    pairs = [(b, k) for b in range(B) for k in blk.touched[b]]
    D = xs.shape[-1]
    n = torch.zeros((B, NS), dtype=m.dtype, device=dev)
    sx = torch.zeros((B, NS, D), dtype=m.dtype, device=dev)
    ssq = (torch.zeros((B, NS, D, D), dtype=m.dtype, device=dev)
           if m.fam.second_moments else None)
    if pairs:
        st = blk.pair_stats(m, pairs)
        for i, (b, k) in enumerate(pairs):
            j = len(where[b])
            where[b][k] = j
            slot_k[b, j] = k
            n[b, j], sx[b, j] = st[0][i], st[1][i]
            if ssq is not None:
                ssq[b, j] = st[2][i]
    safe_n = torch.where(n > 0, n, 1.0)
    params = list(m.params(safe_n, sx, None if ssq is None else
                           torch.where((n > 0)[..., None, None], ssq,
                                       unigram._eye_like(ssq))))
    out_ks = np.full((B, S), -1, dtype=np.int64)
    j_prev = np.full(B, -1, dtype=np.int64)
    gaps = np.zeros(B)
    bad = 0
    g = noise[:, :S].to(m.dtype)
    rows = torch.arange(B, device=dev)
    for s in range(S):
        live = [b for b in range(B) if E[b, s] >= 0]
        if not live:
            continue
        used = torch.as_tensor(slot_k >= 0, device=dev)
        kk = torch.as_tensor(slot_k.clip(0), device=dev)
        post_s = m.fam.logpdf(tuple(params), xs[:, s, None, :])     # [B,NS]
        post_s = torch.where(n > 0, post_s, prior[:, s, None])
        cnt = g_n[None].repeat(B, 1)
        post = base[:, s].clone()
        bi = rows[:, None].expand(B, NS)[used]
        cnt[bi, kk[used]] = n[used]
        post[bi, kk[used]] = post_s[used]
        logits = lmb.weights(j_prev) + torch.where(cnt > 0, post,
                                                   prior[:, s, None])
        pert = (logits / temp + g[:, s]).cpu().numpy()
        empty = (cnt <= 0).cpu().numpy()
        moved = []
        for b in live:
            first = int(np.argmax(empty[b])) if empty[b].any() else -1
            if ks is None:
                k = int(np.argmax(pert[b]))
                k = k if not empty[b, k] else first
            else:
                k = int(ks[b, s])
                if k < 0 or k >= K or (empty[b, k] and k != first):
                    bad += 1
                    gaps[b] = np.inf
                    continue
                val = (pert[b][empty[b]].max() if empty[b, k]
                       else pert[b, k])
                gaps[b] = max(gaps[b], pert[b].max() - val)
            out_ks[b, s] = k
            j_prev[b] = k
            if k not in where[b]:   # a new slot from the global statistics
                j = len(where[b])
                where[b][k] = j
                slot_k[b, j] = k
                n[b, j], sx[b, j] = blk.g[0][k], blk.g[1][k]
                if ssq is not None:
                    ssq[b, j] = blk.g[2][k]
            moved.append((b, where[b][k]))
        if not moved:
            continue
        bs = torch.tensor([b for b, _ in moved], device=dev)
        js = torch.tensor([j for _, j in moved], device=dev)
        x, xx = m.item_terms(xs[bs, s])
        n[bs, js] += 1
        sx[bs, js] += x
        if ssq is not None:
            ssq[bs, js] += xx
        new = m.params(n[bs, js], sx[bs, js],
                       None if ssq is None else ssq[bs, js])
        for t, v in zip(params, new):
            t[bs, js] = v
    return gaps, out_ks, bad


def judge_block(m: Model, lm: LM, cap: dict, temps) -> dict:
    """Readings of one captured block step (:func:`.unigram.judge_block`
    with the LM's scores and chains)."""
    t = m.t
    blk = Block(m, cap["idx"], cap["assign_before"], cap["bounds_before"])
    lmb = LMBlock.of_block(lm, m, blk, cap["bounds_before"])
    B = len(blk.idx)
    live = [i for i, u in enumerate(cap["idx"]) if u >= 0]
    ref = block_scores(m, blk, lmb.log_uni())
    got = torch.as_tensor(cap["scores"], device=m.device)[live].to(m.dtype)
    fr, fg = torch.isfinite(ref), torch.isfinite(got)
    mismatch = int((fr != fg).sum())
    both = fr & fg
    err = ((got - ref).abs() / ref.abs().clamp_min(1.0))[both]
    score_err = float(err.max()) if err.numel() else 0.0
    score_med = float(err.median()) if err.numel() else 0.0
    lengths = t.lengths[blk.idx]
    lpc = common.log_p_continue(float(blk.g[0].sum()), t.U,
                                m.cfg["beta_sent_boundary"])
    nl, rev = common.node_logits(ref, lengths, lpc, m.cfg["n_slices_min"])
    dp_b = np.asarray(cap["dp_bounds"])[live]
    dp_noise = torch.as_tensor(cap["dp_noise"], device=m.device)[live]
    gaps, path, mag = common.dp_gaps(nl, rev, dp_noise, lengths, dp_b,
                                     temps[0])
    dp_gap = float(gaps.max()) if B else 0.0
    lp = torch.as_tensor(cap["dp_log_prob"]).double().cpu().numpy()[live]
    path_err = unigram._rel_err(lp, path, mag) if B else 0.0
    E = new_segments(m, blk, dp_b)
    ks = np.asarray(cap["chain_ks"])[live][:, :E.shape[1]]
    c_noise = torch.as_tensor(cap["chain_noise"], device=m.device)[live]
    gaps, _, bad = chain(m, blk, lmb, E, c_noise, temps[1], ks=ks)
    mismatch += bad + int(((E < 0) & (ks >= 0)).sum())
    want = common.decollide(ks, E >= 0, blk.lo_counts.long().cpu().numpy(),
                            blk.g[0].long().cpu().numpy())
    a = blk.assign.copy()
    for b in range(B):
        a[[e for e in blk.old[b] if e >= 0]] = -1
    for b in range(B):
        ok = E[b] >= 0
        a[E[b][ok]] = want[b][ok]
    mismatch += int((a != np.asarray(cap["assign_after"])).sum())
    bb = np.asarray(cap["bounds_before"]).copy()
    bb[blk.idx] = dp_b
    mismatch += int((bb != np.asarray(cap["bounds_after"])).sum())
    return {"score_err": score_err, "score_med": score_med,
            "dp_gap": dp_gap, "path_err": path_err,
            "chain_gap": float(gaps.max()) if B else 0.0,
            "mismatch": mismatch}


def final_transcripts(tables: common.Tables, cap: dict) -> list:
    """Every utterance's transcript at the check sweep's end."""
    return all_transcripts(tables, np.asarray(cap["sweep_end"]["assign"]),
                           np.asarray(cap["blocks"][-1]["bounds_after"]))


def _lpz_err(got: float, ref: float) -> float:
    if not (math.isfinite(got) and math.isfinite(ref)):
        return float("inf")
    return abs(got - ref) / max(abs(ref), 1.0)


# -------------------------------------------------------------- the judge

def _empty() -> dict:
    out = {k: 0.0 for k in READINGS}
    out["mismatch"] = 0
    return out


def judge(cfg, tables, cap: dict, device, seed: int) -> dict:
    """The readings of a captured check sweep, in float64."""
    m = Model(cfg, tables, device, torch.float64)
    lm = LM(cfg, m.K)
    out = _empty()
    unigram._merge(out, stats_readings(m, cap["window_end"]["stats"],
                                       cap["window_end"]["assign"]))
    for blk in cap["blocks"]:
        unigram._merge(out, judge_block(m, lm, blk, cap["temps"]))
    unigram._merge(out, stats_readings(m, cap["sweep_end"]["stats"],
                                       cap["sweep_end"]["assign"]))
    ref = lm.log_prob_z(final_transcripts(tables, cap))
    out["lpz_err"] = _lpz_err(float(cap["objective"]["log_prob_z"][-1]), ref)
    return unigram._draws(out)


def control(cfg, tables, cap: dict, device, seed: int) -> dict:
    """The same readings with the reference itself in the program's
    place, computed in float32 with TF32 matrix products (its replay's
    logs formed and summed in float32), and judged in float64 by
    :func:`judge`'s own functions."""
    ref = Model(cfg, tables, device, torch.float64)
    low = Model(cfg, tables, device, torch.float32)
    lm = LM(cfg, ref.K)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = _empty()
        a = cap["window_end"]["assign"]
        unigram._merge(out, stats_readings(ref, low.stats(a, tf32=True), a))
        temps = cap["temps"]
        for c in cap["blocks"]:
            blk_l = Block(low, c["idx"], c["assign_before"],
                          c["bounds_before"])
            blk_r = Block(ref, c["idx"], c["assign_before"],
                          c["bounds_before"])
            lm_l = LMBlock.of_block(lm, low, blk_l, c["bounds_before"])
            lm_r = LMBlock.of_block(lm, ref, blk_r, c["bounds_before"])
            live = [i for i, u in enumerate(c["idx"]) if u >= 0]
            s_low = block_scores(low, blk_l, lm_l.log_uni())
            s_ref = block_scores(ref, blk_r, lm_r.log_uni())
            both = torch.isfinite(s_ref)
            err = ((s_low.double() - s_ref).abs()
                   / s_ref.abs().clamp_min(1.0))[both]
            out["score_err"] = max(out["score_err"], float(err.max()))
            out["score_med"] = max(out["score_med"], float(err.median()))
            lengths = tables.lengths[blk_r.idx]
            lpc = common.log_p_continue(float(blk_r.g[0].sum()), tables.U,
                                        cfg["beta_sent_boundary"])
            dp_noise = torch.as_tensor(c["dp_noise"], device=device)[live]
            nl_low, rev_low = common.node_logits(s_low, lengths, lpc,
                                                 cfg["n_slices_min"])
            b_low = common.dp_sample(nl_low, dp_noise, lengths, temps[0])
            nl_ref, rev_ref = common.node_logits(s_ref, lengths, lpc,
                                                 cfg["n_slices_min"])
            gaps, path, mag = common.dp_gaps(nl_ref, rev_ref, dp_noise,
                                             lengths, b_low, temps[0])
            lp_low = common.dp_gaps(nl_low, rev_low, dp_noise, lengths,
                                    b_low, temps[0])[1]
            out["dp_gap"] = max(out["dp_gap"], float(gaps.max()))
            out["path_err"] = max(out["path_err"],
                                  unigram._rel_err(lp_low, path, mag))
            E = new_segments(ref, blk_r, b_low)
            c_noise = torch.as_tensor(c["chain_noise"], device=device)[live]
            _, ks_low, _ = chain(low, blk_l, lm_l, E, c_noise, temps[1])
            gaps, _, _ = chain(ref, blk_r, lm_r, E, c_noise, temps[1],
                               ks=ks_low)
            out["chain_gap"] = max(out["chain_gap"], float(gaps.max()))
        ts = final_transcripts(tables, cap)
        out["lpz_err"] = _lpz_err(lm.log_prob_z(ts, torch.float32),
                                  lm.log_prob_z(ts))
        return unigram._draws(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
