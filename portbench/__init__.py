"""The H100 benchmark of the PyTorch + CUDA port (see README.md)."""
