"""Worker processes of `test_torch_distributed.py` (no tests of its own).

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
