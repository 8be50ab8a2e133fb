"""localdiffusion_tpu_torch: the PyTorch/CUDA port of localdiffusion_tpu.

The JAX package `localdiffusion_tpu` is the reference; this package imports
nothing of it, nor JAX, nor YAML on its serving path.  This slice ports the
28px flagship's Stage-B serving path: InferenceServer → pipeline.translate →
the plain and branched DDPM samplers → GaussianDiffusion → UNet, with the
fused GroupNorm+FiLM+SiLU as a CUDA kernel (`csrc/groupnorm_film_silu.cu`).
"""
