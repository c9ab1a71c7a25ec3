"""f32 products as the JAX package computes them: without TF32.

Under f32 parameters the JAX package computes the SAM2 encoder's patch
embedding and neck (XLA convolutions) and the LM's `lm_head` in f32 with
f32 operands. PyTorch on the card may round f32 operands of a product to
TF32: `torch.backends.cudnn.allow_tf32` (convolutions) is on by default, and
`torch.backends.cuda.matmul.allow_tf32` (matmul, `F.linear`) is off by
default but a caller may turn it on. `exact_f32(x)` turns both off around
such a call when x is f32, and puts back what the caller had after it, so
no process-wide default changes for other paths.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32(x: torch.Tensor):
    """TF32 off for the products inside, when x is an f32 CUDA tensor."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
