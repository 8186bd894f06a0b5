"""Ops of the port: RMSNorm, attention (flash prefill + ragged decode
kernels with their plain PyTorch versions) and the kernel build."""
