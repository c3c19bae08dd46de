"""Plain reference of the unigram blocked Gibbs sampler, and the judge
that holds a captured sweep of the program to it.

A block step (kamperh/segmentalist ``unigram_acoustic_wordseg.py``,
blocked as ``segmentalist_torch/segmenters/unigram.py`` states it):

1. leave each utterance of the block out of the statistics;
2. score every candidate span: ``logsumexp_k(w_k + log p(x | k))`` with
   the Dirichlet weights of the leave-out counts (with their denominator)
   and the prior density for empty components, times the duration, plus
   the word insertion penalty;
3. draw the boundaries by forward filtering, backward Gumbel-max sampling;
4. draw each utterance's new segments' components in order, each against
   the leave-out statistics plus the segments before it (weights
   ``log(alpha / K + n_k)``, a draw onto an empty component going to the
   first empty slot);
5. decollide new components across utterances and merge.

With ``am_n_iter`` the sweep starts with the acoustic model's sequential
sweep over its assigned items in index order: each leaves its component,
is drawn against the others as in 4, and joins.

The judge follows the program step by step from its own state (the
assignment vector and boundaries before each block, read back after the
run): at the sizes of the run, every statistic is rebuilt here from that
state and the benchmark's corpus, never taken from the program.  Numbers
(each a maximum over the checked blocks):

* ``score_err`` and ``score_med``: the largest and the median (the
  largest block's) relative error of the candidate scores,
  ``|p - r| / max(|r|, 1)``;
* ``path_err``: the DP's log probability of its own draw against the
  sum of the reference's scores of the drawn segments, over the sum of
  their magnitudes;
* ``draw_gap``: the widest gap, in nats, by which a draw of the program
  falls below the best perturbed choice that the reference finds for it,
  on the noise the benchmark handed it: each node of the DP's path
  (``dp_gap``), each component draw of the chains (``chain_gap``), and a
  seeded sample of the acoustic model's sequential draws with
  ``am_n_iter`` (``item_gap``); one number, as a draw at D 130 is seldom
  near a tie, and the control's lower precision shows in the boundaries
  long before it moves a component draw;
* ``stats_err``: the program's statistics against their rebuild from its
  assignments, ``max |p - r| / max |r|`` for each sum;
* ``mismatch``: exact checks, counted: the masks of the scores, counts,
  the boundaries and assignments that the merge writes against the DP's
  and the decollided chains' outputs, draws onto a non-first empty slot.

:func:`control` makes the same readings with the reference itself in the
program's place, in float32 with TF32 matrix products.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common, families

READINGS = ("score_err", "score_med", "path_err", "draw_gap", "dp_gap",
            "chain_gap", "item_gap", "stats_err", "mismatch")


class Model:
    """The configuration's model on the benchmark's corpus, in ``dtype``
    on ``device``."""

    def __init__(self, cfg: dict, tables: common.Tables, device, dtype):
        self.cfg, self.t = cfg, tables
        self.device, self.dtype = device, dtype
        D, p = cfg["D"], cfg["prior"]

        def vec(v):
            return torch.full((D,), float(v), dtype=dtype, device=device)

        if cfg["family"] == "fixed":
            prior = {"var": vec(p["var"]), "mu_0": vec(p["mu_0"]),
                     "var_0": vec(p["var_0"])}
        else:
            prior = {"m_0": vec(p["m_0"]), "k_0": p["k_0"],
                     "v_0": D + p["v_0_plus_D"],
                     "S_0": p["S_0"] * torch.eye(D, dtype=dtype,
                                                 device=device)}
        self.fam = families.make(cfg["family"], prior)
        self.K, self.alpha, self.lms = cfg["am_K"], cfg["am_alpha"], cfg["lms"]
        self.X = torch.as_tensor(tables.X, device=device).to(dtype)

    def stats(self, assign, tf32: bool = False):
        """(counts [K], sum_x [K, D], sum_sq or None) of an assignment
        vector, rebuilt from the corpus as one-hot matrix products (in
        TF32 only where ``tf32`` asks: the control's own rebuild)."""
        a = torch.as_tensor(assign, device=self.device).long()
        rows = (a >= 0).nonzero()[:, 0]
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            n, sx, ssq = common.one_hot_sums_chunked(
                self.X[rows], a[rows], self.K, self.fam.second_moments)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        return n.to(self.dtype), sx, ssq

    def sel(self, st, k):
        n, sx, ssq = st
        return n[k], sx[k], None if ssq is None else ssq[k]

    def params(self, n, sx, ssq):
        return self.fam.params(n, sx, ssq)

    def item_terms(self, x):
        """(x, x x^T or None) of rows x [.., D]."""
        return x, (x[..., :, None] * x[..., None, :]
                   if self.fam.second_moments else None)

    def post_all(self, st, X):
        """[R, K] log predictive of rows X [R, D] under every component of
        the statistics ``st``: occupied ones by their posterior, empty
        ones by the prior."""
        n = st[0]
        occ = (n > 0).nonzero()[:, 0]
        prior = self.fam.log_prior(X)
        out = prior[:, None].expand(X.shape[0], self.K).clone()
        if occ.numel():
            out[:, occ] = self.fam.logpdf_rows(
                self.params(*self.sel(st, occ)), X)
        return out


# -------------------------------------------------------------- one block

class Block:
    """A block at its start: its utterances' old segments and leave-out
    statistics, from the program's state ``assign`` / ``bounds``."""

    def __init__(self, m: Model, idx, assign, bounds):
        t = m.t
        self.idx = [int(u) for u in idx if u >= 0]
        self.assign = np.asarray(assign)
        self.g = m.stats(assign)
        B = len(self.idx)
        self.old = [t.embeds(u, bounds[u]) for u in self.idx]
        self.touched = []   # per row: {k: (own count, own embeds)}
        for emb in self.old:
            own = {}
            for e in emb:
                k = int(self.assign[e]) if e >= 0 else -1
                if k >= 0:
                    own.setdefault(k, []).append(e)
            self.touched.append(own)
        lo = self.g[0][None].repeat(B, 1)
        for b, own in enumerate(self.touched):
            for k, es in own.items():
                lo[b, k] -= len(es)
        self.lo_counts = lo

    def pair_stats(self, m: Model, pairs):
        """Leave-out statistics of the (row, component) ``pairs``, stacked:
        the global ones less the row's own segments."""
        ks = [k for _, k in pairs]
        n, sx, ssq = (None if t is None else t[ks].clone()
                      for t in self.g)
        for i, (b, k) in enumerate(pairs):
            es = self.touched[b].get(k, [])
            if es:
                x, xx = m.item_terms(m.X[es])
                n[i] -= len(es)
                sx[i] -= x.sum(0)
                if xx is not None:
                    ssq[i] -= xx.sum(0)
        return n, sx, ssq


def block_scores(m: Model, blk: Block):
    """[B, N_max, W] reference candidate scores of the block."""
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
    w = common.log_weights(lo, m.alpha, m.K, m.lms, True)           # [B, K]
    logits = w[:, None, :] + torch.where(lo[:, None, :] > 0, post,
                                         prior[..., None])
    margs = torch.logsumexp(logits, dim=-1).reshape(B, N_max, W)
    scale = torch.where(torch.isnan(durs), 0.0, durs) ** cfg["time_power_term"]
    scores = margs * scale + cfg["wip"]
    bad = (ids < 0) | torch.isnan(durs)
    return torch.where(bad, common.NEG_INF, scores)


def new_segments(m: Model, blk: Block, bounds_rows):
    """[B, S] embedding ids of the new segmentation (-1 pads)."""
    emb = [m.t.embeds(u, bounds_rows[b]) for b, u in enumerate(blk.idx)]
    S = max(1, max(len(e) for e in emb))
    E = np.full((len(emb), S), -1, dtype=np.int64)
    for b, e in enumerate(emb):
        E[b, :len(e)] = e
    return E


def chain(m: Model, blk: Block, E, noise, temp: float, ks=None):
    """The block's assignment chains over the new segments E [B, S]
    (noise [B, >= S, K]).  With ``ks`` [B, S] (a run's draws) the judge:
    returns (per-row widest gap, ks as given, bad draws); without, the
    sampler: (zeros, its own draws, 0).

    Components whose statistics a row changes (those it left out and
    those its chain joins) live in per-row slots; the rest keep their
    global statistics and scores."""
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
    # the slots' predictive parameters (a placeholder where a slot is
    # unused or empty: its score is the prior's)
    safe_n = torch.where(n > 0, n, 1.0)
    params = list(m.params(safe_n, sx, None if ssq is None else
                           torch.where((n > 0)[..., None, None], ssq,
                                       _eye_like(ssq))))
    out_ks = np.full((B, S), -1, dtype=np.int64)
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
        logits = common.log_weights(cnt, m.alpha, K, m.lms, False) \
            + torch.where(cnt > 0, post, prior[:, s, None])
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


def _rel_err(got, ref, scale) -> float:
    """max ``|got - ref| / max(scale, 1)``; inf where either is not
    finite."""
    ok = np.isfinite(got) & np.isfinite(ref)
    if not ok.all():
        return float("inf")
    return float((np.abs(got - ref) / np.maximum(scale, 1.0)).max())


def _eye_like(ssq):
    return torch.eye(ssq.shape[-1], dtype=ssq.dtype, device=ssq.device)


def judge_block(m: Model, cap: dict, temps) -> dict:
    """Readings of one captured block step (``cap``: the state before,
    the noise, the scorer's output as the DP took it, the DP's draw, the
    chains' draws, the state after)."""
    t = m.t
    blk = Block(m, cap["idx"], cap["assign_before"], cap["bounds_before"])
    B = len(blk.idx)
    live = [i for i, u in enumerate(cap["idx"]) if u >= 0]
    ref = block_scores(m, blk)
    got = torch.as_tensor(cap["scores"], device=m.device)[live].to(m.dtype)
    fr, fg = torch.isfinite(ref), torch.isfinite(got)
    mismatch = int((fr != fg).sum())
    both = fr & fg
    err = ((got - ref).abs() / ref.abs().clamp_min(1.0))[both]
    score_err = float(err.max()) if err.numel() else 0.0
    score_med = float(err.median()) if err.numel() else 0.0
    lengths = t.lengths[blk.idx]
    n_min = m.cfg["n_slices_min"]
    lpc = common.log_p_continue(float(blk.g[0].sum()), t.U,
                                m.cfg["beta_sent_boundary"])
    nl, rev = common.node_logits(ref, lengths, lpc, n_min)
    dp_b = np.asarray(cap["dp_bounds"])[live]
    dp_noise = torch.as_tensor(cap["dp_noise"], device=m.device)[live]
    gaps, path, mag = common.dp_gaps(nl, rev, dp_noise, lengths, dp_b,
                                     temps[0])
    dp_gap = float(gaps.max())
    lp = torch.as_tensor(cap["dp_log_prob"]).double().cpu().numpy()[live]
    path_err = _rel_err(lp, path, mag)
    E = new_segments(m, blk, dp_b)
    ks = np.asarray(cap["chain_ks"])[live][:, :E.shape[1]]
    c_noise = torch.as_tensor(cap["chain_noise"], device=m.device)[live]
    gaps, _, bad = chain(m, blk, E, c_noise, temps[1], ks=ks)
    mismatch += bad + int(((E < 0) & (ks >= 0)).sum())
    # the merge: decollided draws, boundaries and assignments written
    want = common.decollide(ks, E >= 0, blk.lo_counts.long().cpu().numpy(),
                            blk.g[0].long().cpu().numpy())
    a = blk.assign.copy()
    for b in range(B):
        olds = [e for e in blk.old[b] if e >= 0]
        a[olds] = -1
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


def stats_readings(m: Model, st_prog, assign) -> dict:
    """The program's statistics (counts, sum_x, sum_sq) against their
    rebuild from its assignment vector."""
    n, sx, ssq = m.stats(assign)
    pn, psx, pssq = (None if v is None else torch.as_tensor(v, device=m.device)
                     for v in st_prog)
    mismatch = int((pn.long() != n.long()).sum())
    errs = [float((psx.to(m.dtype) - sx).abs().max()
                  / sx.abs().max().clamp_min(1e-30))]
    if pssq is not None:
        if pssq.dim() == 2:   # elementwise second moments
            a = torch.as_tensor(assign, device=m.device).long()
            rows = (a >= 0).nonzero()[:, 0]
            ref = common.one_hot_sums_chunked(
                m.X[rows] ** 2, a[rows], m.K, False)[1]
        else:
            ref = ssq
        errs.append(float((pssq.to(m.dtype) - ref).abs().max()
                          / ref.abs().max().clamp_min(1e-30)))
    return {"stats_err": max(errs), "mismatch": mismatch}


def item_steps(m: Model, cap: dict, sample, temp: float, draw: bool):
    """The acoustic model's sequential sweep at the positions ``sample``
    of its item order (the items assigned before it, by index): per
    position the gap of the program's draw (``draw`` False) or the
    reference's own draw judged the same way (``draw`` True: the
    control's)."""
    before = np.asarray(cap["assign_before"])
    after = np.asarray(cap["assign_after"])
    ids = np.nonzero(before >= 0)[0]
    noise = cap["noise"]
    gaps, bad = [], 0
    for p in sample:
        i = int(ids[p])
        a = before.copy()
        a[ids[:p]] = after[ids[:p]]
        a[i] = -1
        st = m.stats(a)
        x = m.X[i]
        post = m.post_all(st, x[None])[0]
        cnt = st[0]
        logits = common.log_weights(cnt, m.alpha, m.K, m.lms, False) \
            + torch.where(cnt > 0, post, m.fam.log_prior(x))
        pert = (logits / temp + torch.as_tensor(
            noise[i], device=m.device).to(m.dtype)).cpu().numpy()
        empty = (cnt <= 0).cpu().numpy()
        first = int(np.argmax(empty)) if empty.any() else -1
        if draw:
            k = int(np.argmax(pert))
            k = first if empty[k] else k
            gaps.append((k, pert))
            continue
        k = int(after[i])
        if k < 0 or (empty[k] and k != first):
            bad += 1
            gaps.append(np.inf)
            continue
        val = pert[empty].max() if empty[k] else pert[k]
        gaps.append(float(pert.max() - val))
    return gaps, bad


def item_sample(cap: dict, n: int, seed: int) -> list:
    """Positions of the sequential sweep to check: ``n`` drawn from
    ``seed``, with the last (the longest chain before it)."""
    n_items = int((np.asarray(cap["assign_before"]) >= 0).sum())
    rng = np.random.RandomState(seed % 2 ** 32)
    pick = rng.choice(n_items - 1, size=min(n, n_items) - 1, replace=False)
    return sorted(set(pick.tolist()) | {n_items - 1})


# -------------------------------------------------------------- the judge

def _merge(out: dict, r: dict):
    for k, v in r.items():
        out[k] = out.get(k, 0) + v if k == "mismatch" else max(
            out.get(k, 0.0), v)


def judge(cfg, tables, cap: dict, device, seed: int) -> dict:
    """The readings of a captured check sweep, in float64."""
    m = Model(cfg, tables, device, torch.float64)
    out = {k: 0.0 for k in READINGS}
    out["mismatch"] = 0
    _merge(out, stats_readings(m, cap["window_end"]["stats"],
                               cap["window_end"]["assign"]))
    if cap.get("am_sweep"):
        am = cap["am_sweep"]
        _merge(out, stats_readings(m, am["stats_after"], am["assign_after"]))
        gaps, bad = item_steps(m, am, item_sample(am, cap["check_items"],
                                                  seed), am["temp"], False)
        out["mismatch"] += bad
        out["item_gap"] = max(gaps)
    for blk in cap["blocks"]:
        _merge(out, judge_block(m, blk, cap["temps"]))
    _merge(out, stats_readings(m, cap["sweep_end"]["stats"],
                               cap["sweep_end"]["assign"]))
    return _draws(out)


def _draws(out: dict) -> dict:
    out["draw_gap"] = max(out["dp_gap"], out["chain_gap"], out["item_gap"])
    return out


def control(cfg, tables, cap: dict, device, seed: int) -> dict:
    """The same readings with the reference in the program's place,
    computed in float32 with TF32 matrix products, and judged in float64
    by :func:`judge`'s own functions."""
    ref = Model(cfg, tables, device, torch.float64)
    low = Model(cfg, tables, device, torch.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = {k: 0.0 for k in READINGS}
        out["mismatch"] = 0
        a = cap["window_end"]["assign"]
        _merge(out, stats_readings(ref, low.stats(a, tf32=True), a))
        if cap.get("am_sweep"):
            am = cap["am_sweep"]
            sample = item_sample(am, cap["check_items"], seed)
            draws, _ = item_steps(low, am, sample, am["temp"], True)
            fake = dict(am, assign_after=np.asarray(am["assign_after"]).copy())
            ids = np.nonzero(np.asarray(am["assign_before"]) >= 0)[0]
            for p, (k, _) in zip(sample, draws):
                fake["assign_after"][ids[p]] = k
            gaps, _ = item_steps(ref, fake, sample, am["temp"], False)
            out["item_gap"] = max(gaps)
        temps = cap["temps"]
        for c in cap["blocks"]:
            blk_l = Block(low, c["idx"], c["assign_before"],
                          c["bounds_before"])
            blk_r = Block(ref, c["idx"], c["assign_before"],
                          c["bounds_before"])
            live = [i for i, u in enumerate(c["idx"]) if u >= 0]
            s_low = block_scores(low, blk_l)
            s_ref = block_scores(ref, blk_r)
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
                                  _rel_err(lp_low, path, mag))
            E = new_segments(ref, blk_r, b_low)
            c_noise = torch.as_tensor(c["chain_noise"], device=device)[live]
            _, ks_low, _ = chain(low, blk_l, E, c_noise, temps[1])
            gaps, _, _ = chain(ref, blk_r, E, c_noise, temps[1], ks=ks_low)
            out["chain_gap"] = max(out["chain_gap"], float(gaps.max()))
        return _draws(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
