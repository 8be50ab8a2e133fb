"""The diffusion engine and the DDPM samplers."""
