"""Component models and the FBGMM container."""
