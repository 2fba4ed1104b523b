"""Tools that read the runtime's output: ``trace_merge`` folds the
per-rank timeline traces into one view, ``critical_path`` attributes each
step's time to ranks and phases.  The runtime imports nothing from here."""
