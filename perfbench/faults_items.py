"""A fault of the acoustic model's sequential sweep (K10, K11) that its
check can see at D 130.  ``faults.py``'s ``items_altered`` draws each item
on its noise row scaled thirtyfold; at D 130 the components' log
predictives differ by thousands of nats, so no draw moves and the fault
is no fault there.  This one moves draws where the item chain makes them,
consistently with the statistics it keeps: the CPU tests run it on the
tiny cells, ``faults_bigram.py --fault item_draws_altered`` reads it at a
cell's own size on the card."""


def _item_draws_altered(monkeypatch):
    """Every seventh item of a sweep drawn onto another component: its
    noise row raised by 1e5 at the column after its old one (column 0 for
    an unassigned item), so the chain takes that column, or the first
    empty one where it is empty, and updates its statistics to match."""
    from segmentalist_torch.models import fbgmm

    inner = fbgmm.item_chain

    def chain(family, X, log_prior, noise, k_old, *a, **k):
        if noise is None:   # an argmax chain draws on no noise
            return inner(family, X, log_prior, noise, k_old, *a, **k)
        noise = noise.clone()
        rows = noise.new_zeros(noise.shape[0], dtype=bool)
        rows[::7] = True
        cols = (k_old.long().clamp_min(-1) + 1) % noise.shape[1]
        noise[rows, cols[rows]] += 1e5
        return inner(family, X, log_prior, noise, k_old, *a, **k)

    monkeypatch.setattr(fbgmm, "item_chain", chain)


FAULTS = {"item_draws_altered": _item_draws_altered}
