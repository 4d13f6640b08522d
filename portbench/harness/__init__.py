"""What every cell's run shares: loading a cell, the window arithmetic, the
profiled slice, the readings handed to the metric readers, the result line."""
