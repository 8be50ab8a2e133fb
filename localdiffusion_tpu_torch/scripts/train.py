"""Train the denoiser of a configuration: the port of `scripts/train.py`.

    python -m localdiffusion_tpu_torch.scripts.train --config mri256 --steps 400
        [--step-mode resident|epoch|batch] [--batch-size N] [--results DIR]
        [--eval-every N] [--resume auto|never] [--init-npz NPZ]
        [--dtype float32|bfloat16] [--export-npz NPZ] [--device cuda|cpu]
        [--mnist-path IDX --mnist-labels-path IDX | --mri-files GLOB | --mvtec-path GLOB]
        [--coordinator HOST:PORT --num-processes N --process-id I] [--fsdp]

`--config` names a builder of `config.CONFIGS` or a `.json`/`.yaml`
configuration file (`config.load_config`; the card's machine reads `.json`).  Steps (`train.trainer.Trainer`): 'resident' (the default) keeps
the training set on the device and takes one optimizer step an epoch over
its drop-last batches; 'epoch' streams the epoch's batches from the host
(the short last batch included) into one step; 'batch' takes one step a
batch.  Each step's draws come from a generator seeded from (seed, step),
so a resumed run draws what the uninterrupted run drew.  Every
`--eval-every` steps (default a quarter of the run) the EMA model samples 8
test images; the best milestone and `model-latest.pt` are saved under
`<results>/<project_name>`, with `best_eval.json` and an append-only
`train_loss.csv`.  `--init-npz` warm-starts the parameters and the EMA
from a slim npz (the optimizer starts fresh); `--export-npz` writes the
final EMA as one, which `factory.load_params` and the JAX package's
`load_params_npz` read.  On the card unless `--device cpu`.

Datasets (`data.datasets.train_arrays`, the JAX script's branches):
`mnist` (the digit-8 images of the idx files, a 70% split; synthetic digits
where the files are missing), `synthetic_brain`, `synthetic_texture[_denoise]`,
`synthetic`, `mri` (BraTS PNG triplets) and `mvtec*`; `--mnist-path`,
`--mnist-labels-path`, `--mri-files` and `--mvtec-path` point the
configuration at the files.

Several processes (one a device, each launched with the same command and its
own `--process-id`; `--coordinator` is rank 0's host:port) train as one:
the process group joins over TCP (NCCL on the card, gloo on the CPU), every
rank loads the same training set, trimmed to a multiple of the number of
ranks, and keeps its rows of each global batch; `--fsdp` shards the
parameters, the optimizer's state and the EMA over the ranks
(`parallel.fsdp`).  Only rank 0 writes the log and the checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from localdiffusion_tpu_torch.config import CONFIG_HELP, load_config, min_max_val_for
from localdiffusion_tpu_torch.data.datasets import add_data_args, train_arrays, with_data_paths
from localdiffusion_tpu_torch.data.loader import ArrayLoader
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd, resolve_device
from localdiffusion_tpu_torch.parallel import multihost
from localdiffusion_tpu_torch.train.trainer import (
    Trainer,
    load_best_eval,
    record_best_eval,
    round_milestone,
)
from localdiffusion_tpu_torch.utils.logging import CsvLogger, Timer
from localdiffusion_tpu_torch.utils.params_io import load_params_npz, save_params_npz

EVAL_IMAGES = 8


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's draws, from the run's seed and the step alone."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mri256", help=CONFIG_HELP)
    ap.add_argument("--steps", type=int, default=None,
                    help="optimizer steps (default: the configuration's num_steps)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="default: the configuration's train.batch_size")
    ap.add_argument("--results", default=None, help="results directory (default: the "
                    "configuration's train.results_dir)")
    ap.add_argument("--step-mode", choices=["resident", "epoch", "batch"], default="resident")
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--resume", choices=["auto", "never"], default="auto",
                    help="auto: resume from model-latest.pt if it is there")
    ap.add_argument("--init-npz", default=None,
                    help="warm-start params and EMA from a slim npz; the optimizer starts fresh")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                    help="compute dtype (default: the configuration's)")
    ap.add_argument("--export-npz", default=None, help="write the final EMA to this slim npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (several processes only)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params, optimizer state and EMA over the ranks (parallel/fsdp.py)")
    add_data_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)
    joined_here = not torch.distributed.is_initialized()
    # before any tensor reaches the card
    multihost.init_distributed(args.coordinator, args.num_processes, args.process_id,
                               device=args.device)
    device = multihost.rank_device(args.device)
    cfg = with_data_paths(load_config(args.config), args)
    over = {"batch_size": args.batch_size or cfg.train.batch_size}
    if args.results:
        over["results_dir"] = args.results
    if args.dtype:
        over["compute_dtype"] = args.dtype
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **over))
    bs = cfg.train.batch_size

    gd = build_gd(cfg, device=device)
    mesh = None
    if args.coordinator is not None:
        from localdiffusion_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data=multihost.process_count(), patch=1, device=device)
        multihost.warmup_collectives()
        print(f"multi-process: {multihost.process_count()} processes, mesh "
              f"data={multihost.process_count()}, rank {multihost.process_index()} on {device}"
              f"{', FSDP' if args.fsdp else ''}")
    init_state = load_params_npz(args.init_npz, gd.model) if args.init_npz else None
    n_params = sum(p.numel() for p in gd.model.parameters() if p.requires_grad)
    trainer = Trainer(gd, cfg.train, mesh=mesh, fsdp=args.fsdp and mesh is not None)
    print(f"Total number of parameters: {n_params}")
    if init_state is not None:
        trainer.load_params(init_state)
        trainer.reset_ema()
        print(f"warm-started params from {args.init_npz}")
    latest = trainer.checkpoint_path("latest")
    if args.resume == "auto" and os.path.exists(latest):
        trainer.load("latest")
        print(f"auto-resumed from {latest} at step {trainer.step}")
    start_step = trainer.step

    (hr_tr, lr_tr), (hr_te, lr_te) = train_arrays(cfg)
    if mesh is not None:
        # each rank keeps a share of every batch: drop the tail so the count
        # divides by the data width (DataLoader drop_last)
        d = multihost.process_count()
        n_keep = (len(hr_tr) // d) * d
        if n_keep != len(hr_tr):
            print(f"trimming train set {len(hr_tr)} -> {n_keep} (divisible by data={d})")
            hr_tr, lr_tr = hr_tr[:n_keep], lr_tr[:n_keep]
    print(f"train {len(hr_tr)} / test {len(hr_te)} samples")
    dl = ArrayLoader(hr_tr, lr_tr, batch_size=bs, seed=42)
    steps = args.steps if args.steps is not None else cfg.train.num_steps
    save_every = args.eval_every or max(1, steps // 4)
    best = load_best_eval(trainer.results_dir) if args.resume == "auto" else float("inf")
    if best < float("inf"):
        print(f"best-eval tracker resumed at {best:.5f}")

    os.makedirs(trainer.results_dir, exist_ok=True)
    csv_path = os.path.join(trainer.results_dir, "train_loss.csv")
    primary = multihost.is_primary()
    if primary and start_step == 0 and os.path.exists(csv_path):
        os.replace(csv_path, csv_path + ".prev")  # a fresh run: keep the old log aside
    logger = CsvLogger(csv_path, ["step", "loss", "time_s"]) if primary else None
    timer = Timer()
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    if args.step_mode == "resident":
        data_hr, data_lr = (torch.as_tensor(a, device=device) for a in (hr_tr, lr_tr))
    mmv = min_max_val_for(cfg)
    losses, evals = [], []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            draws = torch.Generator(device=device).manual_seed(step_seed(cfg.train.seed, step))
            with timer.time("train_step", sync):
                if args.step_mode == "resident":
                    loss = trainer.train_epoch_resident(data_hr, data_lr, draws)
                elif args.step_mode == "epoch":
                    loss = trainer.train_epoch_step(dl.epoch_batches(step), draws)
                else:
                    hr_b, lr_b = next(iter(dl.epoch_batches(step)))
                    loss = trainer.train_batch_step(hr_b, lr_b, draws)
            losses.append(loss)
            if logger:
                logger.log(step=step, loss=loss, time_s=f"{time.time() - t0:.2f}")
            if step % 10 == 0 or step == steps - 1:
                print(f"step {step}: loss {loss:.5f} ({time.time() - t0:.1f}s)")
            if (step + 1) % save_every == 0 or step == steps - 1:
                with timer.time("eval_sample", sync):
                    m = trainer.eval_sample_mse(hr_te[:EVAL_IMAGES], lr_te[:EVAL_IMAGES], 0,
                                                min_max_val=mmv)
                evals.append(m)
                print(f"  eval sample MSE: {m:.5f}")
                if m < best:
                    best = m
                    milestone = "best" + round_milestone(step + 1)
                    trainer.save(milestone)
                    if primary:
                        record_best_eval(trainer.results_dir, m, milestone)
                    print(f"  saved {milestone}")
                with timer.time("checkpoint"):
                    trainer.save("latest")
        trainer.save("latest")
    finally:
        if logger:
            logger.close()
    if args.export_npz:
        ema = trainer.ema_state_dict()
        if primary:
            save_params_npz(args.export_npz, ema)
            print(f"exported the EMA to {args.export_npz}")
    phase_means = {k: f"{v * 1e3:.1f}ms" for k, v in timer.summary().items()}
    print(f"phase means: {phase_means}")
    print("done")
    rank, world = multihost.process_index(), multihost.process_count()
    if joined_here and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return dict(start_step=start_step, step=trainer.step, losses=losses, evals=evals,
                best=best, phase_means_s=timer.summary(), results_dir=trainer.results_dir,
                rank=rank, world=world)


if __name__ == "__main__":
    main()
