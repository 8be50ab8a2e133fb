"""Worker processes of `test_torch_distributed.py`,
`test_torch_mesh_serving.py` and `test_torch_tensor_parallel.py` (no tests
of its own).

Each worker blocks JAX, flax, optax, Orbax and the JAX package before it
imports anything (an entry of None in sys.modules makes an import fail),
joins a gloo process group on the CPU through
`parallel.multihost.init_distributed`, runs every job (one spawn serves
the whole test file) and puts the results, numpy only, on a queue.  Its
helpers (the configuration, the batches) serve the test process too,
which runs the one-process references.
"""

import dataclasses
import os
import sys
import traceback

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "localdiffusion_tpu")

ROWS = 8  # the global batch
SHORT = 3  # a streamed epoch's short last batch: split 2 + 1 over two ranks


def block_jax():
    for name in BLOCKED:
        sys.modules[name] = None


def tiny_config():
    """A narrow `mri256_config()`: dim 8, mults 1/2, 16px, T=10, f32."""
    from localdiffusion_tpu_torch import config as tcfg

    base = tcfg.mri256_config()
    model = tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1,
                             resnet_block_groups=4, attn_heads=2, attn_dim_head=8)
    return base.replace(
        model=model,
        diffusion=dataclasses.replace(base.diffusion, image_size=16, timesteps=10,
                                      sampling_timesteps=None),
        train=dataclasses.replace(base.train, compute_dtype="float32", batch_size=4,
                                  lr=1e-3, project_name="tiny"))


def ema_config():
    """The EMA updated at every step from the first, so that a few steps
    move it."""
    from localdiffusion_tpu_torch.train.trainer import EmaConfig

    return EmaConfig(update_every=1, update_after_step=0)


def batches():
    import numpy as np

    rng = np.random.default_rng(0)
    hr = rng.uniform(0, 2, (ROWS + SHORT, 16, 16, 1)).astype(np.float32)
    lr = rng.uniform(0, 2, (ROWS + SHORT, 16, 16, 1)).astype(np.float32)
    return hr, lr


def train_steps(mesh=None, fsdp=False):
    """A trainer on `tiny_config()` (on the CPU) after a batch step, a
    streamed epoch of a full and a short batch, and a resident epoch:
    (trainer, losses)."""
    import torch

    from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
    from localdiffusion_tpu_torch.train.trainer import Trainer

    cfg = tiny_config()
    tr = Trainer(build_gd(cfg, device="cpu"), cfg.train, ema_cfg=ema_config(), mesh=mesh,
                 fsdp=fsdp)
    hr, lr = batches()
    losses = [tr.train_batch_step(hr[:ROWS], lr[:ROWS], torch.Generator().manual_seed(1))]
    losses.append(tr.train_epoch_step([(hr[:4], lr[:4]), (hr[ROWS:], lr[ROWS:])],
                                      torch.Generator().manual_seed(2)))
    losses.append(tr.train_epoch_resident(torch.as_tensor(hr[:ROWS]), torch.as_tensor(lr[:ROWS]),
                                          torch.Generator().manual_seed(3)))
    return tr, losses


def eval_then_step(tr):
    """The EMA's eval chain, then one more batch step: (MSE, the state
    unchanged by the eval, the step's loss)."""
    import torch

    mse, kept = eval_mse(tr)
    hr, lr = batches()
    return mse, kept, tr.train_batch_step(hr[:ROWS], lr[:ROWS], torch.Generator().manual_seed(4))


def eval_mse(tr):
    """The EMA's eval chain (DDPM, T=10) on the global batch, with the
    model's state unchanged by it: (MSE, unchanged)."""
    import numpy as np

    hr, lr = batches()
    before = state_arrays(tr)
    mse = tr.eval_sample_mse(hr[:ROWS], lr[:ROWS], 7, min_max_val=(0.0, 2.0))
    after = state_arrays(tr)
    same = all(np.array_equal(before[part][k], after[part][k])
               for part in before for k in before[part])
    return mse, same


def state_arrays(tr):
    """{'params': ..., 'ema': ...} of full numpy arrays (collective)."""
    from localdiffusion_tpu_torch.parallel import fsdp as F

    return {name: {k: v.detach().numpy().copy() for k, v in F.gather_tree(m).items()}
            for name, m in (("params", tr.model), ("ema", tr.ema_model))}


def patch_inputs():
    import numpy as np

    rng = np.random.default_rng(5)
    cond = rng.uniform(0, 2, (1, 32, 32, 1)).astype(np.float32)
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 4:12, 20:30] = 1.0
    return cond, mask


def patch_engine():
    from localdiffusion_tpu_torch.diffusion.gaussian import build_gd

    cfg = tiny_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, image_size=32,
                                                    sampling_timesteps=3))
    return build_gd(cfg, device="cpu"), cfg


def _group_jobs(rank, world, port, workdir):
    """The jobs that share one gloo group: the replicated and FSDP steps,
    the FSDP state saved and loaded, patch sampling."""
    import torch

    from localdiffusion_tpu_torch.parallel import fsdp as F
    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel.mesh import make_mesh
    from localdiffusion_tpu_torch.parallel.patch import patch_parallel_sample

    multihost.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(data=world, device="cpu")
        multihost.warmup_collectives()
        out = {}
        for kind in ("replicated", "fsdp"):
            tr, losses = train_steps(mesh, fsdp=kind == "fsdp")
            mse, kept, loss = eval_then_step(tr)
            out[kind] = dict(losses=losses + [loss], eval=mse, eval_kept_state=kept,
                             state=state_arrays(tr))
        out["info"] = F.shard_info(tr.state_tensors())
        tr.results_dir = workdir
        tr.save("1")
        fresh, _ = train_steps(mesh, fsdp=True)  # other values, then loaded over
        fresh.results_dir = workdir
        fresh.load("1")
        out["reloaded"] = state_arrays(fresh)
        out["adam"] = F.full_optimizer_state(fresh.optimizer)["state"][0]["exp_avg"].numpy()
        gd, cfg = patch_engine()
        cond, mask = patch_inputs()
        out["patch"] = patch_parallel_sample(gd, cond, mask, cfg.sampler, (0.0, 2.0), 16, 4,
                                             noise=9, group=mesh.get_group("data")).numpy()
        return out
    finally:
        torch.distributed.destroy_process_group()


def _cli_jobs(rank, world, port, workdir):
    """The training CLI with --fsdp on `world` ranks: one epoch step, then
    resumed to two (each run joins and leaves its own group)."""
    from localdiffusion_tpu_torch import config as tcfg
    from localdiffusion_tpu_torch.scripts import train

    tcfg.CONFIGS["tiny"] = tiny_config
    common = ["--config", "tiny", "--results", os.path.join(workdir, "cli"), "--device", "cpu",
              "--step-mode", "epoch", "--batch-size", "128", "--eval-every", "1", "--fsdp",
              "--num-processes", str(world), "--process-id", str(rank)]
    first = train.main(common + ["--steps", "1", "--coordinator", f"localhost:{port + 1}"])
    second = train.main(common + ["--steps", "2", "--coordinator", f"localhost:{port + 2}"])
    return dict(first=first["losses"], second=second["losses"], start=second["start_step"],
                rank=second["rank"], world=second["world"])


def run(rank, world, port, workdir, queue):
    """Entry point of a spawned worker: (rank, {'group': ..., 'cli': ...})
    or (rank, error text) on `queue`."""
    block_jax()
    import torch

    torch.set_num_threads(1)
    try:
        queue.put((rank, dict(group=_group_jobs(rank, world, port, workdir),
                              cli=_cli_jobs(rank, world, port, workdir))))
    except BaseException:  # reported to the test, which fails on it
        queue.put((rank, "error: " + traceback.format_exc()))
        raise


# ---------------------------------------------------------------------------
# mesh serving (test_torch_mesh_serving.py): one spawn serves the file
# ---------------------------------------------------------------------------

MESH_S, MESH_B = 12, 4  # 12px: SSIM's 11x11 window fits
MESHES = ((2, 1), (1, 2))  # (data, patch)
CHAINS = ("ddpm", "gated", "ddim")
GATE_BUDGET = 2
# the scripted gate's verdicts [T, B]: True where a row is rejected at step
# t; rows 0-1 pass at once, rows 2-3 are rejected until the budget, so a
# rank of the data = 2 mesh latches while the other still retries
GATE_REJECTS = ((), (1,), (3, 2, 1), (3, 2))


def mesh_config(chain: str):
    """A narrow flagship (`flagship_config()`: manual mask, cond policy,
    fusion at t=2) with a dim-8 two-stage UNet at 12px, f32: 'ddpm' T=6;
    'gated' the same fused at t=4, gated with GATE_BUDGET retries; 'ddim'
    T=10 in 5 DDIM steps."""
    from localdiffusion_tpu_torch import config as tcfg

    base = tcfg.flagship_config()
    model = tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1,
                             resnet_block_groups=4, attn_heads=2, attn_dim_head=8)
    cfg = base.replace(
        model=model,
        diffusion=dataclasses.replace(base.diffusion, image_size=MESH_S, timesteps=6),
        ood=dataclasses.replace(base.ood, input_size=MESH_S, manual_mask_cols=3, mask_dilate=1))
    if chain == "gated":
        cfg = cfg.replace(sampler=dataclasses.replace(
            cfg.sampler, start_timestep=4, classifier=True, max_classifier_retries=GATE_BUDGET))
    if chain == "ddim":
        cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, timesteps=10,
                                                        sampling_timesteps=5))
    return cfg


def gate_table(timesteps: int):
    import numpy as np

    table = np.zeros((timesteps, MESH_B), bool)
    for b, ts in enumerate(GATE_REJECTS):
        table[list(ts), b] = True
    return table


def scripted_gate(table, rows=slice(None)):
    """The scripted classifier on a rank's rows of the batch: -1 (reject)
    where the table says, else 1."""
    import torch

    return lambda xs, t: torch.where(torch.as_tensor(table[t][rows]), -1.0, 1.0)


def mesh_inputs():
    """(lr, hr, the masks of the branched dispatches: the left 3 columns
    anomalous, one row also half soft)."""
    import numpy as np

    rng = np.random.default_rng(12)
    lr = rng.uniform(0, 2, (MESH_B, MESH_S, MESH_S, 1)).astype(np.float32)
    hr = rng.uniform(0, 2, (MESH_B, MESH_S, MESH_S, 1)).astype(np.float32)
    mask = np.zeros((MESH_B, MESH_S, MESH_S, 1), np.float32)
    mask[:, :, :3] = 1.0
    mask[1, :6, 6:] = 0.5
    return lr, hr, mask


def mesh_pipeline(chain: str, weights: str, mesh=None, rows=slice(None)):
    """The port's pipeline of `mesh_config(chain)` on the CPU with the
    weights saved at `weights`; the gated chain with the scripted gate on
    `rows`."""
    import torch

    from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
    from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline

    cfg = mesh_config(chain)
    gd = build_gd(cfg, device="cpu")
    gd.model.load_state_dict(torch.load(weights, weights_only=True))
    gate = scripted_gate(gate_table(cfg.diffusion.timesteps), rows) if chain == "gated" else None
    return LocalDiffusionPipeline(cfg, gd, classifier_gate=gate, mesh=mesh)


def mesh_translate(pipe, chain: str) -> dict:
    """A chain's translate, numpy out: the DDPM chain with Stage A (the
    manual detector) and the metrics, the others under the given mask."""
    lr, hr, mask = mesh_inputs()
    if chain == "ddpm":
        res = pipe.translate(lr, hr=hr, noise=3)
    else:
        res = pipe.translate(lr, hr=hr, noise=3, mask=mask)
    return {k: v for k, v in res.items() if k != "time"}


def mesh_requests():
    """Four requests: two masked, one uniform, one to the detector."""
    import numpy as np

    lr, _, mask = mesh_inputs()
    ones = np.ones_like(mask[0])
    return list(lr), [mask[0], ones, None, mask[3]]


def mesh_serve(pipe) -> list:
    """The four requests through a server of batch 4 (one merged dispatch
    after the warm-up's two), each result's pred."""
    from localdiffusion_tpu_torch.serving import InferenceServer

    srv = InferenceServer(pipe, batch_size=MESH_B, max_wait_ms=2000, base_seed=5)
    lrs, masks = mesh_requests()
    futs = [srv.submit(x, mask=m) for x, m in zip(lrs, masks)]
    srv.start(warmup=True)
    try:
        return [f.result(timeout=120)["pred"] for f in futs]
    finally:
        srv.stop()


def _mesh_jobs(rank, world, port, weights):
    import numpy as np
    import torch

    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from localdiffusion_tpu_torch.serving import InferenceServer

    multihost.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        multihost.warmup_collectives()
        out = {}
        for data, patch in MESHES:
            mesh = make_mesh(data=data, patch=patch, device="cpu")
            rows = slice(*batch_sharding(mesh).bounds(0, MESH_B))
            res = {}
            for chain in CHAINS:
                pipe = mesh_pipeline(chain, weights, mesh, rows)
                res[chain] = mesh_translate(pipe, chain)
            pipe = mesh_pipeline("ddpm", weights, mesh)
            if multihost.is_primary():
                res["served"] = np.stack(mesh_serve(pipe))
            else:
                res["followed"] = InferenceServer(pipe, batch_size=MESH_B).follow()
            try:
                pipe.translate(mesh_inputs()[0][:3], noise=3)
            except ValueError as e:
                res["indivisible"] = str(e)
            try:
                InferenceServer(pipe, batch_size=3)
            except ValueError as e:
                res["server_indivisible"] = str(e)
            out[f"{data}x{patch}"] = res
        # a rank holding other weights is refused
        gd = mesh_pipeline("ddpm", weights).gd
        if rank == 1:
            with torch.no_grad():
                next(gd.model.parameters()).add_(1.0)
        from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline

        try:
            LocalDiffusionPipeline(mesh_config("ddpm"), gd, mesh=make_mesh(data=2, device="cpu"))
        except ValueError as e:
            out["weights_differ"] = str(e)
        return out
    finally:
        torch.distributed.destroy_process_group()


def run_mesh(rank, world, port, weights, queue):
    """Entry point of a mesh-serving worker: (rank, results) or (rank, error
    text) on `queue`."""
    block_jax()
    import torch

    torch.set_num_threads(1)
    try:
        queue.put((rank, _mesh_jobs(rank, world, port, weights)))
    except BaseException:  # reported to the test, which fails on it
        queue.put((rank, "error: " + traceback.format_exc()))
        raise


# ---------------------------------------------------------------------------
# tensor parallelism (test_torch_tensor_parallel.py): one spawn serves the file
# ---------------------------------------------------------------------------

TP_S = 8  # tests/test_fsdp.py's config: 8px, dim 8, mults 1/2, pred_x0, T=10


def tp_config():
    """`tests/test_fsdp.py::_gd`'s configuration in the port's types."""
    from localdiffusion_tpu_torch import config as tcfg

    return (tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1),
            tcfg.DiffusionConfig(image_size=TP_S, timesteps=10, objective="pred_x0"))


def tp_inputs():
    """tests/test_fsdp.py::test_tp_forward_parity's x, cond and t."""
    import numpy as np

    x = np.random.default_rng(1).uniform(-1, 1, (4, TP_S, TP_S, 1)).astype(np.float32)
    cond = np.random.default_rng(2).uniform(0, 2, (4, TP_S, TP_S, 1)).astype(np.float32)
    return x, cond, np.zeros((4,), np.int64)


def _tp_jobs(rank, world, port, weights, pipe_weights):
    import numpy as np
    import torch

    from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel.mesh import make_mesh
    from localdiffusion_tpu_torch.parallel.tensor_parallel import (
        shard_tensor_parallel,
        tp_info,
        tp_param_shardings,
    )
    from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline

    multihost.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(model=world, device="cpu")
        out = dict(mesh=list(mesh.mesh_dim_names), shape=list(mesh.mesh.shape))
        mcfg, dcfg = tp_config()
        gd = GaussianDiffusion(mcfg, dcfg, device="cpu")
        gd.model.load_state_dict(torch.load(weights, weights_only=True))
        out["specs"] = {k: (tuple(v.spec), v.dim)
                        for k, v in tp_param_shardings(gd.model, mesh).items()}
        shard_tensor_parallel(gd.model, mesh)
        out["local"] = {k: v.detach().numpy().copy() for k, v in gd.model.state_dict().items()}
        out["info"] = tp_info(gd.model)
        x, cond, t = (torch.as_tensor(a) for a in tp_inputs())
        out["apply"] = gd.apply_model(x, cond, t).numpy()
        # a pipeline on the model mesh replicates the denoiser it is given
        pipe = mesh_pipeline("ddim", pipe_weights)
        shard_tensor_parallel(pipe.gd.model, mesh)
        pipe = LocalDiffusionPipeline(pipe.config, pipe.gd, mesh=mesh)
        out["replicated"] = tp_info(pipe.gd.model)["memory_scaling"]
        out["translate"] = mesh_translate(pipe, "ddim")
        return out
    finally:
        torch.distributed.destroy_process_group()


def run_tp(rank, world, port, weights, pipe_weights, queue):
    """Entry point of a tensor-parallel worker: (rank, results) or (rank,
    error text) on `queue`."""
    block_jax()
    import torch

    torch.set_num_threads(1)
    try:
        queue.put((rank, _tp_jobs(rank, world, port, weights, pipe_weights)))
    except BaseException:  # reported to the test, which fails on it
        queue.put((rank, "error: " + traceback.format_exc()))
        raise
