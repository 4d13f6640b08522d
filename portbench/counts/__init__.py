"""Operations and bytes of the benchmarked work, from a configuration and
the shapes of one step or request (``ops.py``), and the card's peaks."""
