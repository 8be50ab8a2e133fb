"""The parallel layer on `torch.distributed` (port of
`localdiffusion_tpu/parallel`): the ('data', 'patch'[, 'model']) mesh and
the row selections a rank keeps, the multi-process runtime, FSDP of the
training state, tensor parallelism over 'model', and patch-parallel
sampling.  A pipeline and a server over a mesh
are `LocalDiffusionPipeline(mesh=...)` and `InferenceServer`.

The exports of `localdiffusion_tpu/parallel/__init__.py` but these, whose
work another object does here:
  * `tree_shardings`, `state_shardings` and `put_tree_sharded` (a sharding
    for every leaf of a tree, and the tree put on it): FSDP2 shards a
    module's parameters itself, so `fsdp.shard_model(model, mesh)` does
    their work, and `fsdp.load_full(model, tensors)` puts full tensors onto
    the shards (and for the 'model' axis,
    `tensor_parallel.shard_tensor_parallel(model, mesh)` cuts a model to
    its `tp_param_shardings`).
"""

from localdiffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    branch_batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from localdiffusion_tpu_torch.parallel.fsdp import (  # noqa: F401
    gather_tree,
    load_full,
    shard_info,
    shard_model,
    spec_for_shape,
)
from localdiffusion_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    is_multiprocess,
    is_primary,
    put_tree,
    sync,
    warmup_collectives,
)
from localdiffusion_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    shard_tensor_parallel,
    tp_info,
    tp_param_shardings,
    unshard_tensor_parallel,
)
from localdiffusion_tpu_torch.parallel.patch import (  # noqa: F401
    PatchGrid,
    extract_patches,
    patch_parallel_sample,
    patch_parallel_sample_bucketed,
    plan_patches,
    stitch_patches,
)
