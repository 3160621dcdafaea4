"""Residue arithmetic, NTT tables and the CUDA kernel wrappers."""
