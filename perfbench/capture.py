"""The check sweep: one more sweep through the driver's own entry point
after the window has closed, on noise the benchmark draws from the seed
and hands to the program's block steps (their ``dp_noise`` /
``chain_noise`` arguments) and to the acoustic model's sequential sweep
(its ``noise``), with the state before and after every block and the
outputs of the stage functions that the reference names (``CAPTURE``)
recorded for the judge.

It wraps the segmenter's ``block_step`` and the acoustic model's
``sequential_sweep`` on the instances, and the named stage functions in
their modules, for that one sweep only; everything is restored before it
returns.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, float32, from the benchmark's generator."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def resolve(spec: str):
    """``"module:attribute"`` -> (module, attribute name)."""
    mod, attr = spec.split(":")
    return importlib.import_module(mod), attr


def _stats(am):
    return tuple(None if t is None else t.clone() for t in am.stats)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype in (torch.bool,
                                                          torch.int32,
                                                          torch.int64):
        return tree.cpu().numpy()
    return tree


def check_sweep(system, sweep, capture: dict, n_max: int, W: int,
                seed: int, check_items: int) -> dict:
    """Run ``sweep()`` once with the capture in place; returns the
    captured record (integer and boolean state on the host, the rest on
    the device)."""
    am, utt = system.acoustic_model, system.utterances
    dev = am.X.device
    K = am.K_max
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 62 + 1)
    cap = {"blocks": [], "temps": (1.0, 1.0), "check_items": check_items,
           "window_end": {"assign": am.assignments.clone(),
                          "stats": _stats(am)}}
    last = {}
    patched = []

    def wrap(role, spec):
        mod, attr = resolve(spec)
        inner = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            out = inner(*args, **kwargs)
            last[role] = (args, out)
            return out

        setattr(mod, attr, wrapped)
        patched.append((mod, attr, inner))

    for role, spec in capture.items():
        wrap(role, spec)
    orig_step = system.block_step
    orig_seq = am.sequential_sweep

    def step(idx_blk, anneal_temp=1.0, assign_temp=1.0, dp_noise=None,
             chain_noise=None):
        B = len(idx_blk)
        dp = gumbel((B, n_max, W), gen, dev)
        ch = gumbel((B, n_max, K), gen, dev)
        a0, b0 = am.assignments.clone(), utt.boundaries_dev.clone()
        last.clear()
        out = orig_step(idx_blk, anneal_temp, assign_temp, dp_noise=dp,
                        chain_noise=ch)
        cap["temps"] = (float(anneal_temp), float(assign_temp))
        cap["blocks"].append({
            "idx": np.asarray(idx_blk), "assign_before": a0,
            "bounds_before": b0, "dp_noise": dp, "chain_noise": ch,
            "scores": last["dp"][0][0].clone(),
            "dp_bounds": last["dp"][1][1].clone(),
            "dp_log_prob": last["dp"][1][0].clone(),
            "chain_ks": last["chain"][1].clone(),
            "assign_after": am.assignments.clone(),
            "bounds_after": utt.boundaries_dev.clone()})
        return out

    def seq(anneal_temp=1.0, consider_unassigned=True, noise=None):
        if consider_unassigned:
            raise RuntimeError("check sweep: the reference orders the "
                               "sequential sweep over assigned items only")
        nz = gumbel((am.X.shape[0], K), gen, dev)
        before = am.assignments.clone()
        orig_seq(anneal_temp, consider_unassigned, noise=nz)
        cap["am_sweep"] = {"assign_before": before,
                           "assign_after": am.assignments.clone(),
                           "noise": nz, "stats_after": _stats(am),
                           "temp": float(anneal_temp)}

    system.block_step = step
    am.sequential_sweep = seq
    try:
        record = sweep()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        del system.block_step
        del am.sequential_sweep
        for mod, attr, inner in patched:
            setattr(mod, attr, inner)
    cap["objective"] = record
    cap["sweep_end"] = {"assign": am.assignments.clone(), "stats": _stats(am)}
    return _host(cap)
