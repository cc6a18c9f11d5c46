"""One reader a metric, found by its name in ``BENCHMARK.json``:
``read(run) -> float | None``.  ``run`` is the record of one run that
:func:`gpubench.harness.run` keeps: ``steps`` and ``window_s`` (the
window's steps and host seconds), ``setup_s``, ``nodes_per_step``,
``peak_bytes``, ``chips``, ``flops_per_step`` and
``aggregate_bytes_per_step`` (the reference's formulas on the real nodes
and edges), ``dtype``, and with ``--trace 1`` ``trace``
(:func:`gpubench.devtrace.summarize` of the traced window).  A reader that
finds nothing to read returns None, and the metric is left out."""
