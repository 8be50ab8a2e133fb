"""The parallel layer: patch-parallel sampling, the mesh's row selections,
FSDP of the training state and the multi-process runtime, on
`torch.distributed` (port of `localdiffusion_tpu/parallel`)."""
