"""Float32 products for the geometry, shared by serving and training."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32_products"]


@contextlib.contextmanager
def full_f32_products():
    """TF32 off for the duration of one forward and its backward passes:
    geometry (frames, Wigner, angles) needs full float32 products.  The
    caller's settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
