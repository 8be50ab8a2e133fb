"""Training: the loss lives in `diffusion.gaussian`, the steps, the EMA,
the optimizer and the checkpoints in `train.trainer`."""
