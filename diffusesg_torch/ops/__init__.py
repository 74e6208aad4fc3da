"""Kernel wrappers (CUDA kernel on the card, plain PyTorch version on the
CPU), masking and the attribute codec."""
