"""localdiffusion_tpu_torch: the PyTorch/CUDA port of localdiffusion_tpu.

The JAX package `localdiffusion_tpu` is the reference; this package imports
nothing of it, nor JAX, nor YAML on its serving path.  It ports Stage B's
serving path: InferenceServer → pipeline.translate → the plain and branched
DDPM and DDIM samplers → GaussianDiffusion → UNet, for the 28px flagship,
the 256px MRI chain and its s2d-stem variant, with every Pallas kernel of
the JAX package as a CUDA kernel in `csrc/`.
"""
