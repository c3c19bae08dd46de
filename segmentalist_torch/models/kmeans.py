"""K-means model (counterpart of ``segmentalist_tpu/models/kmeans.py``;
reference ``kmeans.py`` + ``kmeans_components.py``).

The state is three tensors on one device (:class:`KMeansState`): the
``[N]`` assignment vector (-1 = unassigned), the ``[K]`` counts and the
``[K, D]`` member sums.  A batch ``fit`` step is one ``[N, K]`` distance
matrix, a row argmax and a rebuild of the statistics.  Empty components
take a random data vector as their mean (reference
``kmeans_components.py:90-91, :166``), drawn once at construction into
``random_means``.

Distances take the JAX package's expanded form ``-(x² - 2 x·μ + μ²)`` in
its operation order, so that float64 runs reproduce its argmaxes; the
product is a ``torch.matmul`` (TF32 stays off on the card, see
``device.resolve_device``), as the JAX package leaves it to XLA.  The
statistics are one-hot matrix products: one addition order on every
device, where float scatter-add atomics would add in a run-dependent one.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.stats import one_hot_rows

FIT_RECORD_KEYS = ("sum_neg_sqrd_norm", "components", "n_mean_updates",
                   "sample_time")


class KMeansState(NamedTuple):
    assignments: torch.Tensor  # [N] int32, -1 = unassigned
    counts: torch.Tensor       # [K] int32
    sum_x: torch.Tensor        # [K, D]


def kmeans_state_from_assignments(X: torch.Tensor, assignments: torch.Tensor,
                                  K_max: int) -> KMeansState:
    """The statistics of an assignment vector (unassigned items add
    nothing), as one-hot matrix products."""
    assignments = assignments.to(torch.int32)
    oh = one_hot_rows(assignments, K_max, X.dtype)  # [N, K]
    return KMeansState(assignments=assignments,
                       counts=oh.sum(0).to(torch.int32), sum_x=oh.T @ X)


def means_from_state(state: KMeansState,
                     random_means: torch.Tensor) -> torch.Tensor:
    """[K, D] component means; empty slots fall back to their random mean
    (reference ``kmeans_components.py:90-91, :166, :225``)."""
    c = state.counts.clamp_min(1).to(state.sum_x.dtype)[:, None]
    means = state.sum_x / c
    return torch.where((state.counts > 0)[:, None], means, random_means)


def neg_sqrd_norms(X: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """[M, K] negative squared distances in the expanded form
    ``-((x² - 2 x·μ) + μ²)`` (reference ``neg_sqrd_norm``,
    kmeans_components.py:169-226)."""
    x_sq = (X * X).sum(-1)              # [M]
    m_sq = (means * means).sum(-1)      # [K]
    cross = X @ means.T                 # [M, K]
    return -(x_sq[:, None] - 2.0 * cross + m_sq[None, :])


def sum_neg_sqrd_norm(X: torch.Tensor, state: KMeansState,
                      random_means: torch.Tensor) -> torch.Tensor:
    """K-means objective over the assigned items, a device scalar
    (reference ``sum_neg_sqrd_norm``, kmeans_components.py:234-247)."""
    means = means_from_state(state, random_means)
    assigned = state.assignments >= 0
    d = X - means[state.assignments.clamp_min(0).long()]
    return torch.where(assigned, -(d * d).sum(-1), 0.0).sum()


def fit_step(X: torch.Tensor, state: KMeansState, random_means: torch.Tensor,
             consider_unassigned: bool = True):
    """One batch k-means iteration: every item to its nearest mean (ties
    to the lowest slot), then the statistics rebuilt.  Returns
    ``(new state, number of changed assignments)`` (a device scalar).
    With ``consider_unassigned`` False, unassigned items stay so."""
    means = means_from_state(state, random_means)
    new = neg_sqrd_norms(X, means).argmax(-1).to(torch.int32)
    if not consider_unassigned:
        new = torch.where(state.assignments < 0, state.assignments, new)
    n_updates = (new != state.assignments).sum()
    return (kmeans_state_from_assignments(X, new, state.counts.shape[0]),
            n_updates)


class KMeans:
    """Batch k-means with the reference's API (``kmeans.py:26-177``).

    ``assignments``: an int vector (-1 = unassigned), "rand", "each-in-own"
    or "spread" (reference ``kmeans.py:79-82``).  ``rng`` (a
    ``numpy.random.RandomState``) makes the initial draws: the random
    assignments or the spread's shuffle, then the random means; without
    one they come from numpy's global state, as in the JAX package.  The
    state lives on ``device``: the CUDA card by default (raises when there
    is none), the CPU when the caller asks.
    """

    def __init__(self, X, K, assignments="rand",
                 rng: Optional[np.random.RandomState] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.rng = rng
        self.setup_components(K, assignments, X)

    def setup_components(self, K, assignments="rand", X=None):
        """Reset the state from an assignment vector and draw the random
        means (reference ``setup_components``, kmeans.py:60-95)."""
        if X is not None:
            self.X = torch.as_tensor(X, device=self.device)
            self.N, self.D = self.X.shape
        self.K_max = int(K)
        rand = self.rng if self.rng is not None else np.random
        if isinstance(assignments, str) and assignments == "rand":
            assignments = rand.randint(0, self.K_max, self.N)
        elif isinstance(assignments, str) and assignments == "each-in-own":
            assignments = np.arange(self.N)
        elif isinstance(assignments, str) and assignments == "spread":
            lst = (list(range(self.K_max))
                   * int(np.ceil(float(self.N) / self.K_max)))[: self.N]
            rand.shuffle(lst)
            assignments = np.array(lst)
        elif isinstance(assignments, str):
            raise ValueError("invalid assignments: " + assignments)
        assignments = np.asarray(torch.as_tensor(assignments).cpu(),
                                 dtype=np.int64)
        if assignments.max(initial=-1) >= self.K_max:
            raise ValueError("an assignment exceeds the K slots")
        choice = rand.randint(0, self.N, self.K_max)
        self.random_means = self.X[torch.as_tensor(choice,
                                                   device=self.device)]
        self.state = kmeans_state_from_assignments(
            self.X, torch.as_tensor(assignments, dtype=torch.int32,
                                    device=self.device), self.K_max)

    # ------------------------------------------------------------- queries

    @property
    def K(self) -> int:
        """Number of active (non-empty) components."""
        return int((self.state.counts > 0).sum())

    @property
    def assignments(self) -> torch.Tensor:
        return self.state.assignments

    def means(self) -> torch.Tensor:
        return means_from_state(self.state, self.random_means)

    def get_n_assigned(self) -> int:
        return int((self.state.assignments >= 0).sum())

    def neg_sqrd_norm(self, i: int) -> torch.Tensor:
        return neg_sqrd_norms(self.X[i:i + 1], self.means())[0]

    def max_neg_sqrd_norm_i(self, i: int) -> float:
        return float(self.neg_sqrd_norm(i).max())

    def argmax_neg_sqrd_norm_i(self, i: int) -> int:
        return int(self.neg_sqrd_norm(i).argmax())

    def get_max_assignments(self, list_of_i) -> list:
        """The nearest mean of each listed item."""
        ids = torch.as_tensor(np.asarray(list_of_i, dtype=np.int64),
                              device=self.device)
        return neg_sqrd_norms(self.X[ids], self.means()).argmax(-1).tolist()

    def get_assignments(self, list_of_i) -> np.ndarray:
        return self.state.assignments.cpu().numpy()[np.asarray(list_of_i)]

    def sum_neg_sqrd_norm(self) -> float:
        return float(sum_neg_sqrd_norm(self.X, self.state, self.random_means))

    # ----------------------------------------------------------------- fit

    def fit(self, n_iter: int, consider_unassigned: bool = True,
            no_empty: bool = True) -> dict:
        """Batch k-means iterations that stop early once no assignment
        changes (reference ``fit``, kmeans.py:97-173).  ``no_empty`` is
        accepted for signature parity: empty slots keep their random
        means."""
        record = {k: [] for k in FIT_RECORD_KEYS}
        start = time.time()
        for _ in range(n_iter):
            self.state, n_updates = fit_step(self.X, self.state,
                                             self.random_means,
                                             consider_unassigned)
            n_updates = int(n_updates)
            record["sum_neg_sqrd_norm"].append(self.sum_neg_sqrd_norm())
            record["components"].append(self.K)
            record["n_mean_updates"].append(n_updates)
            record["sample_time"].append(time.time() - start)
            start = time.time()
            if n_updates == 0:
                break
        return record

    @property
    def components(self):
        """Duck-typed view of the reference's component store."""
        return KMeansComponentsView(self)


class KMeansComponentsView:
    """The reference's ``KMeansComponents`` surface over a :class:`KMeans`
    (the JAX package's ``_KMeansComponentsView``, models/kmeans.py:206-320).
    Slots stay stable: a new component takes the first empty slot and no
    deletion relabels the others."""

    def __init__(self, owner: KMeans):
        self._o = owner

    @property
    def X(self):
        return self._o.X

    @property
    def K(self):
        return self._o.K

    @property
    def K_max(self):
        return self._o.K_max

    @property
    def counts(self):
        return self._o.state.counts

    @property
    def assignments(self):
        return self._o.state.assignments

    @property
    def means(self):
        return self._o.means()

    @property
    def mean_numerators(self):
        return self._o.state.sum_x

    @property
    def random_means(self):
        return self._o.random_means

    def neg_sqrd_norm(self, i):
        return self._o.neg_sqrd_norm(i)

    def max_neg_sqrd_norm_i(self, i):
        return self._o.max_neg_sqrd_norm_i(i)

    def argmax_neg_sqrd_norm_i(self, i):
        return self._o.argmax_neg_sqrd_norm_i(i)

    def sum_neg_sqrd_norm(self):
        return self._o.sum_neg_sqrd_norm()

    def get_assignments(self, list_of_i):
        return self._o.get_assignments(list_of_i)

    def get_max_assignments(self, list_of_i):
        return self._o.get_max_assignments(list_of_i)

    def setup_random_means(self):
        """Redraw the empty-slot fallback means from the data (reference
        ``setup_random_means``, kmeans_components.py:90-91)."""
        o = self._o
        rand = o.rng if o.rng is not None else np.random
        choice = rand.randint(0, o.N, o.K_max)
        o.random_means = o.X[torch.as_tensor(choice, device=o.device)]

    def add_item(self, i: int, k: int):
        """Assign ``X[i]`` (unassigned) to slot ``k`` (reference
        ``add_item``, kmeans_components.py:93-111); ``k`` outside
        ``[0, K_max)`` asks for a new component, which takes the first
        empty slot."""
        o, st, i, k = self._o, self._o.state, int(i), int(k)
        if k < 0 or k >= o.K_max:
            empty = np.flatnonzero(st.counts.cpu().numpy() == 0)
            if not empty.size:
                raise ValueError("add_item: a new component needs an empty "
                                 "slot and none is left")
            k = int(empty[0])
        if int(st.assignments[i]) != -1:
            raise ValueError("add_item: item %d is assigned already" % i)
        o.state = _moved(st, i, k, o.X[i], 1)

    def del_item(self, i: int):
        """Remove ``X[i]`` from its component (reference ``del_item``,
        kmeans_components.py:113-147, without the ``no_empty``
        re-initialisation: an emptied slot falls back to its random
        mean)."""
        o, st, i = self._o, self._o.state, int(i)
        k = int(st.assignments[i])
        if k >= 0:
            o.state = _moved(st, i, k, o.X[i], -1)

    def del_component(self, k: int):
        """Unassign component ``k``'s members and zero its statistics
        (reference ``del_component``, kmeans_components.py:149-166); no
        swap-with-last relabelling."""
        o, st, k = self._o, self._o.state, int(k)
        counts, sum_x = st.counts.clone(), st.sum_x.clone()
        counts[k], sum_x[k] = 0, 0.0
        o.state = KMeansState(
            torch.where(st.assignments == k, -1, st.assignments), counts,
            sum_x)

    def clean_components(self):
        """Nothing to do: empty slots are already clean (no relabelling)."""


def _moved(st: KMeansState, i: int, k: int, x: torch.Tensor,
           sign: int) -> KMeansState:
    """The state with item ``i`` (vector ``x``) added to slot ``k``
    (``sign`` 1) or removed from it (-1): one addend an element."""
    assignments, counts, sum_x = (t.clone() for t in st)
    assignments[i] = k if sign > 0 else -1
    counts[k] += sign
    sum_x[k] += sign * x
    return KMeansState(assignments, counts, sum_x)


if __name__ == "__main__":  # smoke demo (reference kmeans.py:176-217, kmeans_components.py:274-324)
    from segmentalist_torch.demos import run_demo

    run_demo("kmeans")
