"""One module per per-layer metric: NAME, UNIT, BETTER, SOURCE, LAYER, the
end-to-end metric it MOVES, the cells it reports in (WORKLOADS; None: every
cell), and ``read``, one of ``portbench.readers``' functions.  The harness
finds them by file (``harness.metric_modules``), so a new metric is a new
file here."""
