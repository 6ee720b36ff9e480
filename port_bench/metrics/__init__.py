"""The per-layer metrics, one reader a metric: ``<name>.py`` defines
``read(ctx)``, which returns the metric's value from the traced window's
context (``core.layer_context``), or None when it finds nothing to read."""
