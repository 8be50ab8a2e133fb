"""The denoiser: UNet, its blocks and the condition encoder."""
