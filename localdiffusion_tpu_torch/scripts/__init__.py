"""Command-line entry points of the port: `test` (a test set through the
pipeline), `eval_margins` (branched against plain, with paired confidence
intervals), `eval_gated_quality` (the classifier gate on the 256px
chain) and `train` (the denoiser's training).  Run each with `python -m localdiffusion_tpu_torch.scripts.<name>`;
on the card unless `--device cpu`."""
