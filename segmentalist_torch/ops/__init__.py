"""Operators of the port: statistics, sampling, the DP and the kernels."""
