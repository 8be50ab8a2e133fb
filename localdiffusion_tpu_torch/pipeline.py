"""Local-diffusion inference pipeline: Stage A, then Stage B.

Port of `localdiffusion_tpu/pipeline.py` (`LocalDiffusionPipeline.translate`,
the evaluation loop `run` and the per-volume `translate_volume`).
Stage A is the caller's mask or the front end's (ood/frontend.py): PatchCore
over the WRN50-2's, the seg encoder's or the denoiser's taps with the
fitted ladder (and hysteresis refinement where configured), the seg
detector's thresholded SegUNet, or the 'manual' and 'none' masks.  Stage B is ancestral DDPM, or DDIM when
the configuration samples fewer steps than it trains (`sampling_timesteps <
timesteps`).  With `sampler.classifier` and a classifier gate
(`factory.build_classifier_gate`), the branched DDPM chain's post-fusion
steps are gated; DDIM has no gate, as in the reference.

On a CUDA device without a mesh, `translate` runs Stage B as compiled
programs, as the JAX pipeline runs its jit-compiled samplers
(`_compile_plain`, `_compile_branched`; `diffusion.compiled`): each
sampler's step bodies are captured as CUDA graphs at the first chain of a
key (program, batch, image size, channels, compute dtype, both TF32 flags,
gated or not, `use_gt`, the sampler settings and the kernel routes) and
replayed at every step after; the weights' fingerprint is checked before
each chain, and a moved parameter drops every program.  The output is the
eager chain's, bit for bit.  A capture or replay failure raises: nothing
carries on eagerly in its place.  On the CPU, which has no CUDA graphs,
and over a mesh, whose gathers are collectives between ranks, `translate`
runs the eager samplers, as `diffusion.sampler.sample` and the sampler
functions themselves always do.

With `mesh=` (`parallel.mesh.make_mesh`, one process a rank, every rank
calling `translate` with the same arguments) the pipeline is the JAX one
over its ('data', 'patch') mesh: every rank holds the same weights
(checked once by digest; on a mesh with a 'model' axis too, where the JAX
pipeline replicates its params, so a tensor-parallel denoiser is gathered
whole), runs its 'data' rows of the batch with noise
drawn for the whole batch and cut to its rows, and steps its 'patch' share
of the branch pair (`parallel.mesh.BranchSplit`); Stage A runs on the
first rank and its mask is broadcast, and the rows are gathered, so every
rank returns what one process returns.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from localdiffusion_tpu_torch.config import Config, min_max_val_for
from localdiffusion_tpu_torch.diffusion import sampler as S
from localdiffusion_tpu_torch.diffusion.compiled import GraphSteps, Programs, kernel_routes
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import StageClock
from localdiffusion_tpu_torch.parallel import multihost as H
from localdiffusion_tpu_torch.parallel.mesh import BranchSplit, batch_sharding
from localdiffusion_tpu_torch.utils.metrics import mse, psnr, ssim

RunNoise = Union[None, int, Callable[[int], object]]


def batch_seed(base_seed: int, index: int) -> int:
    """The noise seed of batch `index`."""
    return int(np.random.SeedSequence([base_seed, index]).generate_state(1)[0])


def batch_noise(noise: RunNoise, index: int):
    """(noise, retry_noise) of batch `index` of a run: with `noise` an int
    seed (None: 0), the seed `batch_seed(noise, index)` (the retries'
    stream derives from it); with a callable, what `noise(index)` returns:
    a seed, a noise source, or a (noise, retry_noise) pair."""
    if noise is None or isinstance(noise, (int, np.integer)):
        return batch_seed(0 if noise is None else int(noise), index), None
    out = noise(index)
    return out if isinstance(out, tuple) else (out, None)


class LocalDiffusionPipeline:
    """Config-driven translation with hallucination suppression."""

    def __init__(self, config: Config, gd: GaussianDiffusion,
                 frontend: Optional[OODFrontend] = None, classifier_gate=None, mesh=None):
        """frontend: Stage A's (`factory.build_frontend(config, gd)`); the
        'manual' and 'none' detectors get theirs here when none is given.
        classifier_gate: `factory.build_classifier_gate(...)`, used when
        `sampler.classifier` is set.  mesh: a ('data', 'patch') mesh over
        the ranks (see the module docstring); raises unless every rank
        holds the same denoiser weights."""
        self.config = config
        self.gd = gd
        self.device = gd.device
        self.min_max_val = min_max_val_for(config)
        if frontend is None and config.ood.detector in ("manual", "none"):
            frontend = OODFrontend(config)
        self.frontend = frontend
        self.classifier_gate = classifier_gate
        self.mesh = mesh
        if mesh is not None:
            if "model" in (mesh.mesh_dim_names or ()):
                # the JAX pipeline puts its params replicated on a model mesh
                # (pipeline.py:48-54): a tensor-parallel denoiser is gathered
                # whole, and the 'model' ranks compute the same rows
                from localdiffusion_tpu_torch.parallel.tensor_parallel import (
                    unshard_tensor_parallel,
                )

                unshard_tensor_parallel(gd.model)
            H.check_replicated(gd.model.state_dict().values(), "denoiser weights")
            self.branch_split = BranchSplit(mesh)
        self.programs = Programs(gd.model, self.device)
        # whether `translate` runs the compiled programs: on a CUDA device
        # without a mesh (cleared, it runs the eager samplers there too)
        self.compiles = self.device.type == "cuda" and mesh is None

    def _key(self, program: str, b: int, **flags) -> tuple:
        gd = self.gd
        return (program, b, gd.image_size, gd.model_cfg.channels, gd.dtype,
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                tuple(sorted(flags.items())), self.config.sampler, self.min_max_val,
                kernel_routes(gd.model))

    def _compile_plain(self, b: int) -> GraphSteps:
        """The compiled plain chain at batch b (DDPM or DDIM as the engine
        samples)."""
        program = "ddim_plain" if self.gd.is_ddim_sampling else "ddpm_plain"
        return self.programs.get(self._key(program, b))

    def _compile_branched(self, b: int, gated: bool, use_gt: bool) -> GraphSteps:
        """The compiled branched chain at batch b, gated or not, from the
        ground truth or not."""
        program = "ddim_branched" if self.gd.is_ddim_sampling else "ddpm_branched"
        return self.programs.get(self._key(program, b, gated=gated, use_gt=use_gt))

    def detect(self, lr: np.ndarray):
        """Stage A for a batch [B, H, W, C]: (mask_pred, binary_mask,
        anomaly_map or None), each [B, H, W, 1].  Raises when the pipeline
        has no front end (a PatchCore detector needs one built)."""
        if self.frontend is None:
            raise ValueError(
                f"detector {self.config.ood.detector!r} needs a front end: pass "
                "frontend=factory.build_frontend(config, gd)[0], or pass mask= to translate")
        return self.frontend.detect(np.asarray(lr, np.float32))

    def translate(self, lr: np.ndarray, hr: Optional[np.ndarray] = None,
                  noise=None, mask: Optional[np.ndarray] = None,
                  gt_region: Optional[np.ndarray] = None,
                  retry_noise=None,
                  clock: Optional[StageClock] = None) -> Dict[str, np.ndarray]:
        """One batch through Stage A and Stage B.

        lr (and hr): [B, H, W, C].  `mask` overrides the detector; without
        it Stage A runs (with `sampler.ood_ad`, else the mask is uniform
        ones) and adds 'anomaly_map' to the result: a PatchCore detector's
        map, or the seg detector's probabilities.
        `noise` is an int seed, a noise source (see diffusion.sampler), or
        None (seed 0).  A uniform-ones mask takes the plain chain, any other
        mask the branched chain, each DDPM or DDIM as the configuration
        says.  'time' is Stage B's.  A gated chain adds 'fusion_time', each
        sample's acceptance step, and draws its retries' noise from
        `retry_noise` (see diffusion.sampler).  `clock` is handed to the
        branched DDPM chain, which marks its stages on it (see
        `diffusion.sampler.ddpm_sample_branched`).
        """
        scfg = self.config.sampler
        dev = self.device
        lr = np.asarray(lr, np.float32)
        n = lr.shape[0]
        if self.mesh is not None and n % self.mesh["data"].size():
            raise ValueError(f"batch {n} not divisible by mesh data width "
                             f"{self.mesh['data'].size()}")
        amap = None
        if mask is None:
            if scfg.ood_ad:
                if self.mesh is None or H.is_primary():
                    mask, _, amap = self.detect(lr)
                if self.mesh is not None:  # the first rank's mask, bit for bit
                    mask, amap = H.broadcast_object((mask, amap))
            else:
                s = self.gd.image_size
                mask = np.ones((n, s, s, 1), np.float32)
        mask = np.asarray(mask, np.float32)
        uniform = bool(np.all(mask == 1.0))
        branch = scfg.branch_out and not uniform
        use_gt = hr is not None and scfg.use_gt and scfg.start_intermediate
        gated = (branch and not self.gd.is_ddim_sampling and scfg.classifier
                 and self.classifier_gate is not None)

        # this rank's rows, and noise drawn for the whole batch cut to them
        rows = slice(None)
        split = None
        if self.mesh is not None:
            rows = slice(*batch_sharding(self.mesh).bounds(0, n))
            if gated:
                retry_noise = H.RowsNoise(S.retry_source(noise, retry_noise, dev), n, rows)
            noise = H.RowsNoise(S.as_noise(noise, dev), n, rows)
            split = self.branch_split
        lr_t = torch.as_tensor(lr[rows], device=dev)
        gt = torch.as_tensor(np.asarray(hr, np.float32)[rows], device=dev) if use_gt else None

        steps = None
        if self.compiles:
            steps = (self._compile_branched(n, gated, use_gt) if branch
                     else self._compile_plain(n))
        # Stage B's clock, between waits for this thread's stream (not the
        # whole device: the server's other thread may be capturing a graph)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        t0 = time.perf_counter()
        mask_t = torch.as_tensor(mask[rows], device=dev)
        fusion_time = None
        with self.programs.lock:
            if self.gd.is_ddim_sampling:
                if branch:
                    out = S.ddim_sample_branched(self.gd, lr_t, mask_t, scfg, self.min_max_val,
                                                 noise=noise, branch_split=split, steps=steps)
                else:
                    out = S.ddim_sample_plain(self.gd, lr_t, self.min_max_val, noise=noise,
                                              steps=steps)
            elif branch:
                gate = self.classifier_gate if gated else None
                out = S.ddpm_sample_branched(self.gd, lr_t, mask_t, scfg, self.min_max_val,
                                             noise=noise, gt=gt, classifier_fn=gate,
                                             return_fusion_time=gated,
                                             retry_noise=retry_noise, clock=clock,
                                             branch_split=split, steps=steps)
                if gated:
                    out, fusion_time = out
            else:
                out = S.ddpm_sample_plain(self.gd, lr_t, self.min_max_val, noise=noise,
                                          steps=steps)
        if self.mesh is not None:
            out = self._gather_rows(out, n)
            if fusion_time is not None:
                fusion_time = self._gather_rows(fusion_time, n)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        dt = time.perf_counter() - t0

        result: Dict[str, np.ndarray] = {
            "pred": out.cpu().numpy(),
            "mask": mask,
            "time": np.asarray(dt),
            "branched": np.asarray(branch),
        }
        if fusion_time is not None:
            result["fusion_time"] = fusion_time.cpu().numpy()
        if amap is not None:
            result["anomaly_map"] = amap
        if hr is not None:
            hr_t = torch.as_tensor(np.asarray(hr, np.float32), device=dev)
            rng = float(self.min_max_val[1])
            result["mse"] = mse(out, hr_t).cpu().numpy()
            result["ssim"] = ssim(out, hr_t, data_range=rng).cpu().numpy()
            result["psnr"] = psnr(out, hr_t, data_range=rng).cpu().numpy()
            if gt_region is not None:
                m = (np.asarray(gt_region, np.float32) > 0).astype(np.float32)
                err = (result["pred"] - np.asarray(hr, np.float32)) ** 2
                result["mse_ood_region"] = np.asarray(
                    float((err * m).sum() / max(float(m.sum()), 1.0))
                )
        return result

    def _gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The n rows of which this rank holds its 'data' share, gathered
        over 'data', as the first rank of its 'patch' group holds them (the
        fused chain runs replicated over 'patch'): the same on every rank."""
        whole = H.all_gather_rows(t, n, self.mesh.get_group("data"))
        return H.broadcast_first(whole, self.mesh.get_group("patch"))

    def run(self, pairs, noise: RunNoise = None, save_prefix: Optional[str] = None,
            verbose: bool = True, gt_masks=None) -> Dict[str, np.ndarray]:
        """The evaluation loop over (hr, lr) batch pairs: each batch through
        `translate` with its own noise (`batch_noise(noise, i)`), then the
        stacks hr_all, lr_all, pred_all, ad_masks and fusion_time (each
        sample's acceptance step; `num_timesteps` where no gate ran),
        mean_mse and mean_time (Stage B's, the first batch left out when
        there are more).  `gt_masks` (one per pair) adds
        mean_mse_ood_region.  With `save_prefix`, the stacks are written as
        `{save_prefix}{name}.npy`, as the JAX pipeline writes them."""
        hrs, lrs, preds, masks, losses, times = [], [], [], [], [], []
        region_losses, fusion_times = [], []
        for i, (hr, lr) in enumerate(pairs):
            n, retry = batch_noise(noise, i)
            gt_m = gt_masks[i] if gt_masks is not None else None
            r = self.translate(lr, hr=hr, noise=n, retry_noise=retry, gt_region=gt_m)
            if "mse_ood_region" in r:
                region_losses.append(float(r["mse_ood_region"]))
            hrs.append(np.asarray(hr))
            lrs.append(np.asarray(lr))
            preds.append(r["pred"])
            masks.append(r["mask"])
            losses.append(float(r["mse"]))
            times.append(float(r["time"]))
            fusion_times.append(r.get(
                "fusion_time", np.full((lr.shape[0],), self.gd.num_timesteps, np.int32)))
            if verbose:
                extra = f" mse_ood={region_losses[-1]:.5f}" if "mse_ood_region" in r else ""
                print(f"[{i}] mse={losses[-1]:.5f} ssim={float(r['ssim']):.4f}{extra} "
                      f"time={times[-1]:.3f}s branched={bool(r['branched'])}")
        out = {
            "hr_all": np.concatenate(hrs),
            "lr_all": np.concatenate(lrs),
            "pred_all": np.concatenate(preds),
            "ad_masks": np.concatenate(masks),
            "fusion_time": np.concatenate(fusion_times),
            "mean_mse": np.asarray(np.mean(losses)),
            "mean_time": np.asarray(np.mean(times[1:]) if len(times) > 1 else times[0]),
        }
        if region_losses:
            out["mean_mse_ood_region"] = np.asarray(np.mean(region_losses))
        if save_prefix is not None:
            for name in ("hr_all", "lr_all", "pred_all", "ad_masks", "fusion_time"):
                np.save(f"{save_prefix}{name}.npy", out[name])
        if verbose:
            print(f"Test loss: {float(out['mean_mse']):.4f}")
            if "mean_mse_ood_region" in out:
                print(f"OOD-region loss: {float(out['mean_mse_ood_region']):.4f}")
            print(f"Average sampling time: {float(out['mean_time']):.4f}")
        return out

    def translate_volume(self, dataset, batch_size: int = 8, noise: RunNoise = None,
                         verbose: bool = True) -> Dict[str, np.ndarray]:
        """Every slice of a per-volume dataset (items (hr, lr) or (hr, lr,
        seg), each [H, W, C]) in batches of `batch_size`, each with its own
        noise (`batch_noise(noise, i)` for batch i): every batch has one
        shape, the last padded by repeating its last slice, and the pad rows
        dropped.  Returns pred_volume, mask_volume, hr_volume, lr_volume,
        mse, branched_batches and, where the segmentation marks a region,
        mean_mse_ood_region, taken over the volume without the pad rows."""
        n = len(dataset)
        items = [dataset[i] for i in range(n)]
        hr = np.stack([it[0] for it in items])
        lr = np.stack([it[1] for it in items])
        seg = np.stack([it[2] for it in items]) if len(items[0]) > 2 else None
        preds, masks, branched = [], [], []
        for b, i in enumerate(range(0, n, batch_size)):
            sel = np.arange(i, min(i + batch_size, n))
            pad = batch_size - len(sel)
            idx = np.concatenate([sel, np.repeat(sel[-1:], pad)]) if pad else sel
            nz, retry = batch_noise(noise, b)
            r = self.translate(lr[idx], hr=hr[idx], noise=nz, retry_noise=retry)
            preds.append(r["pred"][: len(sel)])
            masks.append(r["mask"][: len(sel)])
            branched.append(bool(r["branched"]))
            if verbose:
                print(f"slices {i}-{i + len(sel) - 1}: mse={float(r['mse']):.5f} "
                      f"branched={bool(r['branched'])}")
        pred = np.concatenate(preds)
        out = {
            "pred_volume": pred,
            "mask_volume": np.concatenate(masks),
            "hr_volume": hr,
            "lr_volume": lr,
            "mse": np.asarray(np.mean((pred - hr) ** 2)),
            "branched_batches": int(np.sum(branched)),
        }
        if seg is not None and np.any(seg > 0):
            m = (seg > 0).astype(np.float32)
            err = (pred.astype(np.float32) - hr.astype(np.float32)) ** 2
            out["mean_mse_ood_region"] = np.asarray(float((err * m).sum() / max(float(m.sum()), 1.0)))
        if verbose:
            print(f"volume MSE: {float(out['mse']):.5f} ({n} slices, "
                  f"{out['branched_batches']} branched batches)")
        return out
