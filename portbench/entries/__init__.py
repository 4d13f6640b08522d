"""What a window drives, one module per entry (``run(cell, seed, seconds,
trace, device, phases)``), named by a traffic file's ``entry``."""
