"""Numerics and kernels: schedules, diffusion math, attention, and the fused
GroupNorm+FiLM+SiLU with its CUDA build."""
