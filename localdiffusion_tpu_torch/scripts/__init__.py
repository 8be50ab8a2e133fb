"""Command-line entry points of the port: `test` (a test set through the
pipeline), `eval_margins` (branched against plain, with paired confidence
intervals) and `eval_gated_quality` (the classifier gate on the 256px
chain).  Run each with `python -m localdiffusion_tpu_torch.scripts.<name>`;
on the card unless `--device cpu`."""
