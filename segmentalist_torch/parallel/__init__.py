"""Multi-device scale-out over the corpus axis on ``torch.distributed``
(counterpart of ``segmentalist_tpu/parallel``): ``mesh`` (the exact mode),
``shard_sweep`` (the per-shard collective sweep), ``dryrun`` (the dry run
and its rank launcher)."""

from .mesh import make_mesh, shard_segmenter  # noqa: F401
