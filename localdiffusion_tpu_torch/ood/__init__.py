"""Stage A: PatchCore over the denoiser's taps, the threshold ladders and masks,
the front end and the memory-bank build (ood/bank.py)."""
