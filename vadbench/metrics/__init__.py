"""Per-layer metric readers, one file a metric (or a stem shared by
names <stem>.<suffix>), each `read(rec, name) -> float | None`. `rec`
holds the traced run's TraceSummary (`summary`, None off the card), the
traced window's length (`window_s`), the window's summed work (`work`),
the configuration, the cell and the driver's trace records. A reader
that finds nothing to read returns None and the metric is left out."""
