"""Stereo matchers: plain PyTorch reference paths and the fused kernels."""
