"""What the classifier gate costs a branched chain on the card.

    python -m localdiffusion_tpu_torch.scripts.bench_gated [--sizes 28,256]
        [--timesteps 50] [--start-timestep 5] [--reject-frac 0.2] [--retries 3]
        [--repeats 3] [--real-gate] [--out-dir results_torch]

The port of `scripts/bench_gated.py`.  The reference pays the classifier
only on rejection; the gated sampler latches each sample's acceptance and
stops calling the gate once every sample has accepted.  Per size, three
chains of `ddpm_sample_branched` (T = `--timesteps`, fused at
`--start-timestep`, bf16, seeded random weights from torch seed 0, the
left quarter of each image masked):

  * ungated: no classifier;
  * gated, 0% rejection: a gate that accepts every sample (the latch's
    fast path: the cost over ungated is one gate call a step until all
    accept);
  * gated, scripted rejection: a gate that rejects while t lies in the top
    `--reject-frac` of the post-fusion steps, spending the retry budget
    there (the worst case per rejected step).

The scripted gates cost nothing, so they isolate the chain's structure.
`--real-gate` adds at 256px a live gate: the PatchCore classifier over the
denoiser's own taps of `mri256_gated_config()` (its bank from 8 normal
FLAIR targets, its threshold ROC-calibrated on 8 + 8 pairs, both built
under `build/bench_gated/`), its passes each step being the reference's
cost model.  The models are the JAX script's: at 28px dim 32, mults 1/2/4
(full attention in the last stage), batch 64; at 256px dim 32, mults
1/2/4/8 with the deep condition encoder, batch 4, in the standard layout
(the port runs no s2d layout).  Seconds a chain are host-clock walls over
`--repeats` chains after one warm chain, each ended by a synchronize.
The result goes to `<out-dir>/bench_gated.json` with the card's name and
power limit.  The card is required.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from localdiffusion_tpu_torch.config import DiffusionConfig, ModelConfig, SamplerConfig
from localdiffusion_tpu_torch.diffusion import sampler as S
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.scripts import _measure as M

MIN_MAX_VAL = (0.0, 2.0)
WORK_DIR = os.path.join("build", "bench_gated")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="28,256")
    ap.add_argument("--timesteps", type=int, default=50)
    ap.add_argument("--start-timestep", type=int, default=5)
    ap.add_argument("--reject-frac", type=float, default=0.2)
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--real-gate", action="store_true",
                    help="also time a live PatchCore classifier gate at 256px")
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    args = ap.parse_args(argv)
    args.sizes = [int(s) for s in args.sizes.split(",")]
    return args


def model_for(size: int) -> tuple:
    """(ModelConfig, batch) of the JAX script at `size`."""
    if size <= 64:
        return ModelConfig(dim=32, init_dim=32, dim_mults=(1, 2, 4),
                           full_attn=(False, False, True), channels=1), 64
    return ModelConfig(dim=32, init_dim=32, dim_mults=(1, 2, 4, 8),
                       full_attn=(False, False, False, True), channels=1,
                       cond_encoder_depth="deep"), 4


def reject_cut(timesteps: int, start: int, frac: float) -> float:
    """The scripted gate rejects while t > this: the top `frac` of the
    post-fusion steps."""
    t_hi = timesteps - 1
    return t_hi - frac * (t_hi - start)


def scripted_gates(t_cut: float) -> dict:
    """{'accept_all', 'reject_window'}: gates of (x_start [B, ...], t) →
    score per sample (negative rejects)."""
    def accept_all(xs, t):
        return torch.ones((xs.shape[0],), device=xs.device)

    def reject_window(xs, t):
        return torch.full((xs.shape[0],), -1.0 if int(t) > t_cut else 1.0, device=xs.device)

    return {"accept_all": accept_all, "reject_window": reject_window}


def inputs(batch: int, size: int, device) -> tuple:
    """(cond, mask): the JAX script's cond (numpy seed 0) and mask (the left
    quarter of each image)."""
    rng = np.random.default_rng(0)
    cond = torch.as_tensor(rng.uniform(0, 2, (batch, size, size, 1)).astype(np.float32),
                           device=device)
    mask = torch.zeros((batch, size, size, 1), device=device)
    mask[:, :, : size // 4] = 1.0
    return cond, mask


def measure(gd, scfg, cond, mask, gate, repeats: int) -> tuple:
    """(seconds a chain, the last chain's fusion times or None)."""
    want_ft = gate is not None

    def run(seed):
        out = S.ddpm_sample_branched(gd, cond, mask, scfg, MIN_MAX_VAL, noise=seed,
                                     classifier_fn=gate, return_fusion_time=want_ft)
        torch.cuda.synchronize()
        return out

    run(7)
    t0 = time.perf_counter()
    for i in range(repeats):
        out = run(i)
    dt = (time.perf_counter() - t0) / repeats
    ft = out[1].cpu().numpy().tolist() if want_ft else None
    return dt, ft


def real_gate(gd, size: int):
    """The live classifier gate of `mri256_gated_config()` over `gd`'s taps
    (its bank and calibration built small, under WORK_DIR)."""
    import dataclasses

    from localdiffusion_tpu_torch.config import mri256_gated_config
    from localdiffusion_tpu_torch.factory import build_classifier_gate, classifier_bank_beside
    from localdiffusion_tpu_torch.ood.bank import build_classifier_bank, classifier_calibration_pairs

    base = mri256_gated_config()
    cfg = base.replace(ood=dataclasses.replace(
        base.ood, memory_bank_path=os.path.join(WORK_DIR, "memory_bank_mri256_denoiser.npy")))
    os.makedirs(WORK_DIR, exist_ok=True)
    build_classifier_bank(cfg, classifier_bank_beside(cfg.ood.memory_bank_path, cfg), gd=gd,
                          n_images=8, device=gd.device)
    return build_classifier_gate(cfg, gd=gd, calibration_pairs=classifier_calibration_pairs(
        cfg, n=8), device=gd.device)


def row(size, variant, batch, dt, base_dt, fusion_time) -> dict:
    r = {"size": size, "variant": variant, "batch": batch, "s_per_chain": dt,
         "img_per_s": batch / dt, "vs_ungated": dt / base_dt}
    if fusion_time is not None:
        r["fusion_time_minmax"] = [int(min(fusion_time)), int(max(fusion_time))]
    return r


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = M.card_record()
    device = torch.device("cuda")
    rows = []
    for size in args.sizes:
        mcfg, batch = model_for(size)
        torch.manual_seed(0)
        gd = GaussianDiffusion(mcfg, DiffusionConfig(image_size=size, timesteps=args.timesteps,
                                                     objective="pred_x0"),
                               device=device, dtype=torch.bfloat16)
        cond, mask = inputs(batch, size, device)
        gates = scripted_gates(reject_cut(args.timesteps, args.start_timestep,
                                          args.reject_frac))
        gated = SamplerConfig(start_timestep=args.start_timestep, classifier=True,
                              max_classifier_retries=args.retries)
        variants = [("ungated", SamplerConfig(start_timestep=args.start_timestep), None),
                    ("gated_0pct", gated, gates["accept_all"]),
                    (f"gated_{int(args.reject_frac * 100)}pct", gated, gates["reject_window"])]
        if args.real_gate and size > 64:
            variants.append(("gated_real_patchcore", gated, real_gate(gd, size)))
        base_dt = None
        for name, scfg, gate in variants:
            dt, ft = measure(gd, scfg, cond, mask, gate, args.repeats)
            base_dt = base_dt or dt
            rows.append(row(size, name, batch, dt, base_dt, ft))
            print(rows[-1], flush=True)
    rec = record(args, rows, card)
    M.write_json("bench_gated", rec, args.out_dir)
    return rec


def record(args, rows, card) -> dict:
    return {"script": "bench_gated", "card": card, "timesteps": args.timesteps,
            "start_timestep": args.start_timestep, "reject_frac": args.reject_frac,
            "retries": args.retries, "repeats": args.repeats, "dtype": "bfloat16",
            "weights": "seeded random (torch seed 0)",
            "timing": "host-clock seconds a chain, each ended by torch.cuda.synchronize",
            "rows": rows}


if __name__ == "__main__":
    main()
