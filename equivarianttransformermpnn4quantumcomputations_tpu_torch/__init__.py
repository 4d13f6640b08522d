"""PyTorch + CUDA port of the MatPES GATA-V2 serving and force-training paths.

Mirrors the layout of ``equivarianttransformermpnn4quantumcomputations_tpu``
(the JAX reference): every file here has its counterpart at the same relative
path there.  The port imports ``torch`` and numpy only.  Hand-written Hopper
kernels live in ``csrc/`` and are wrapped by ``ops/cuda/``; each wrapper runs
its plain PyTorch version for CPU tensors and launches its kernel for CUDA
tensors.
"""
