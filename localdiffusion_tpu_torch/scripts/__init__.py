"""Command-line entry points of the port: `test` (a test set through the
pipeline), `eval_margins` (branched against plain, with paired confidence
intervals), `eval_gated_quality` (the classifier gate on the 256px
chain), `train` (the denoiser's training) and the measuring scripts
(`bench_linatt_attrib`, `bench_gated`, `bench_sparse`, `bench_roofline`,
`bench_convgeo`, `bench_quant`, `profile_attr`; on the card only, their
JSON to `results_torch/`).  Run each with `python -m localdiffusion_tpu_torch.scripts.<name>`;
on the card unless `--device cpu`."""
