"""Per-layer metric readers, one file per metric (``<name>.py``), loaded by
name: each states its unit, direction, source, layer and the end-to-end
metric it moves, and ``read(readings)`` returns the value or None when the
run holds nothing to read."""
