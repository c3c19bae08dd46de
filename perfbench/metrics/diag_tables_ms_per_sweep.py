"""diag_tables_ms_per_sweep (ms): device time a sweep of the kernels
launched inside the program's ``seg.diag.tables`` spans, the diagonal-
covariance family's [B, D, K] tables (the leave-out's ``sum_xT`` /
``sum_sqT`` and the predictive ``m_nT``, ``varT``, ``1 / varT`` and log
variances), summed over the profiled sweeps and divided by them.

Each kernel is given to the span inside which its launch was made: the
profiler links it to the innermost host operation open at its launch, and a
host event's ``device_time_total`` sums the kernels linked to it and to the
operations it holds.  The span is read from the host events and not named
in ``RANGES``: a program without it (none before it was added) gives no
reading, and the metric is left out, where a range would fail the run."""

RANGES = {}
SPAN = "seg.diag.tables"


def read(ctx):
    spans = [e for e in ctx.host if e.name == SPAN]
    if not spans:
        return None
    return sum(e.device_time_total for e in spans) / 1e3 / ctx.sweeps
