"""Runnable examples of the port: ``python -m
segmentalist_torch.examples.<name> [--device cpu]``."""
