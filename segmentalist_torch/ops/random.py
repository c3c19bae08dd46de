"""Categorical sampling primitives (counterpart of
``segmentalist_tpu/ops/random.py``).

Gumbel-max draws from ``softmax(logits / T)``.  Every sampler here takes its
noise as an argument (or draws it from an explicit ``torch.Generator``), so
a test can hand the port the very noise the JAX package drew.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def gumbel(shape, generator: torch.Generator, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` with ``u`` kept inside the open
    interval ``(0, 1)``: ``torch.rand`` may return 0, so it is clamped up to
    the smallest normal number, as ``jax.random.gumbel`` draws its uniform
    from ``[tiny, 1)``.  ``-log(-log(0))`` never occurs."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = u.clamp_min(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def gumbel_max(logits: torch.Tensor, noise: torch.Tensor,
               dim: int = -1) -> torch.Tensor:
    """Index drawn from ``softmax(logits)`` along ``dim`` given Gumbel noise
    of the same shape; ``-inf`` entries are never selected (as long as one
    entry is finite).  Ties break to the first index."""
    perturbed = torch.where(torch.isneginf(logits), NEG_INF, logits + noise)
    return torch.argmax(perturbed, dim=dim)


def annealed_gumbel_max(logits: torch.Tensor, noise: torch.Tensor,
                        anneal_temp, dim: int = -1) -> torch.Tensor:
    """Draw from ``softmax(logits / anneal_temp)`` (reference annealing
    transform, ``fbgmm.py:380-383``)."""
    scaled = torch.where(torch.isneginf(logits), NEG_INF, logits / anneal_temp)
    return gumbel_max(scaled, noise, dim=dim)


def logsumexp(a: torch.Tensor, dim: int = -1,
              keepdim: bool = False) -> torch.Tensor:
    """``-inf``-safe logsumexp: an all ``-inf`` slice reduces to ``-inf``
    (no NaNs)."""
    m = torch.amax(a, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    out = torch.log(torch.sum(torch.exp(a - m_safe), dim=dim,
                              keepdim=True)) + m_safe
    out = torch.where(torch.isneginf(m), NEG_INF, out)
    return out if keepdim else out.squeeze(dim)
