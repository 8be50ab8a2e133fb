"""Patch-parallel local diffusion: tile, sample every patch, stitch.

Port of `localdiffusion_tpu/parallel/patch.py`.  A large image is cut into
overlapping patches (`plan_patches`: the last row and column clamped to the
border); every patch is a chain of its own in one [B·P] batch at the patch
resolution (`patch_parallel_sample`), and the patches are stitched back
with a linear feather over the overlap (`stitch_patches`: a scatter-add
divided by the summed weights).

The JAX function shards the [B·P] rows over a mesh; here a process group
does: each rank samples a contiguous share of the rows, draws the noise of
the whole batch and keeps its rows (so the image does not depend on the
number of ranks), and the rows are all-gathered, so every rank stitches
the same image.  The patch chain runs on a shallow copy of the engine
with `image_size` set to the patch, never on the caller's engine.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.diffusion import sampler as S
from localdiffusion_tpu_torch.parallel import multihost


@dataclass(frozen=True)
class PatchGrid:
    """Static tiling geometry."""

    image_hw: Tuple[int, int]
    patch: int
    stride: int  # patch - overlap
    origins: Tuple[Tuple[int, int], ...]  # (y, x) top-left corners

    @property
    def num_patches(self) -> int:
        return len(self.origins)


def plan_patches(h: int, w: int, patch: int, overlap: int = 0) -> PatchGrid:
    """Cover [h, w] with patches of size `patch`, stepping patch - overlap;
    the last row and column are clamped to the border."""
    if patch > h or patch > w:
        raise ValueError(f"patch {patch} is larger than the image {h}x{w}")
    stride = patch - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} leaves no stride in a patch of {patch}")

    def starts(dim):
        s = list(range(0, dim - patch + 1, stride))
        if s[-1] != dim - patch:
            s.append(dim - patch)
        return s

    origins = tuple((y, x) for y in starts(h) for x in starts(w))
    return PatchGrid((h, w), patch, stride, origins)


def extract_patches(img: torch.Tensor, grid: PatchGrid) -> torch.Tensor:
    """[B, H, W, C] → [B·P, p, p, C] (patch-major within each image)."""
    p = grid.patch
    parts = [img[:, y:y + p, x:x + p, :] for (y, x) in grid.origins]
    return torch.stack(parts, dim=1).reshape(-1, p, p, img.shape[-1])


def _feather_weight(patch: int, overlap: int) -> np.ndarray:
    """Separable linear ramp over the overlap margin (1 in the interior)."""
    w1 = np.ones(patch, np.float32)
    if overlap > 0:
        ramp = (np.arange(1, overlap + 1, dtype=np.float32)) / (overlap + 1)
        w1[:overlap] = ramp
        w1[-overlap:] = ramp[::-1]
    return np.outer(w1, w1)


def stitch_patches(patches: torch.Tensor, grid: PatchGrid, batch: int,
                   overlap: int = 0) -> torch.Tensor:
    """[B·P, p, p, C] → [B, H, W, C] with overlap feathering (scatter-add,
    then a division by the summed weights, at least 1e-8)."""
    p = grid.patch
    h, w = grid.image_hw
    c = patches.shape[-1]
    pp = patches.reshape(batch, grid.num_patches, p, p, c)
    weight = torch.as_tensor(_feather_weight(p, overlap), device=patches.device)[None, :, :, None]
    out = torch.zeros((batch, h, w, c), dtype=patches.dtype, device=patches.device)
    norm = torch.zeros((batch, h, w, 1), dtype=torch.float32, device=patches.device)
    for i, (y, x) in enumerate(grid.origins):
        out[:, y:y + p, x:x + p] = out[:, y:y + p, x:x + p] + pp[:, i] * weight
        norm[:, y:y + p, x:x + p] = norm[:, y:y + p, x:x + p] + weight
    return out / torch.clamp(norm, min=1e-8)


def _patch_engine(gd, patch: int):
    """A shallow copy of `gd` sampling at the patch resolution (the
    caller's engine, which other code shares, is left as it is)."""
    gd_patch = copy.copy(gd)
    gd_patch.image_size = patch
    return gd_patch


def _chain(gd_patch, cond_p, mask_p, scfg, min_max_val, noise, branched: bool):
    if branched:
        fn = S.ddim_sample_branched if gd_patch.is_ddim_sampling else S.ddpm_sample_branched
        return fn(gd_patch, cond_p, mask_p, scfg, min_max_val, noise=noise)
    fn = S.ddim_sample_plain if gd_patch.is_ddim_sampling else S.ddpm_sample_plain
    return fn(gd_patch, cond_p, min_max_val, noise=noise)


def _as_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32, device=device)


@torch.no_grad()
def patch_parallel_sample(gd, cond, mask, scfg, min_max_val: Tuple[float, float], patch: int,
                          overlap: int = 0, noise=None, group=None) -> torch.Tensor:
    """Branched local diffusion over a tiled batch of patches.

    cond, mask: [B, H, W, C] at full resolution (tensors or numpy, moved to
    `gd`'s device).  Every patch is an independent chain in one [B·P]
    batch at `image_size = patch`, DDIM or DDPM as `gd` samples; a patch
    whose mask tile is uniformly one runs the same branched chain (its OOD
    branch sees empty conditioning and fusion reduces to the IND
    estimate).  `noise` as the samplers take it, drawn for the [B·P]
    batch.  With a process group (`group`), each rank samples its
    `multihost.row_range` share of the rows and every rank returns the
    whole stitched image."""
    device = gd.device
    cond, mask = _as_tensor(cond, device), _as_tensor(mask, device)
    b, h, w, _ = cond.shape
    grid = plan_patches(h, w, patch, overlap)
    gd_patch = _patch_engine(gd, patch)
    cond_p = extract_patches(cond, grid)
    mask_p = extract_patches(mask, grid)
    n = cond_p.shape[0]
    if group is None or not multihost.is_multiprocess():
        out_p = _chain(gd_patch, cond_p, mask_p, scfg, min_max_val, noise, branched=True)
        return stitch_patches(out_p, grid, b, overlap)
    import torch.distributed as dist

    lo, hi = multihost.row_range(n, dist.get_rank(group), dist.get_world_size(group))
    if hi <= lo:
        raise ValueError(f"{n} patch rows leave rank {dist.get_rank(group)} no row")
    rows = multihost.RowsNoise(S.as_noise(noise, device), n, slice(lo, hi))
    mine = _chain(gd_patch, cond_p[lo:hi], mask_p[lo:hi], scfg, min_max_val, rows, branched=True)
    return stitch_patches(multihost.all_gather_rows(mine, n, group), grid, b, overlap)


def _extract_patches_np(img: np.ndarray, grid: PatchGrid) -> np.ndarray:
    """Host-side patch extraction, same [B·P] ordering as extract_patches."""
    p = grid.patch
    parts = [img[:, y:y + p, x:x + p, :] for (y, x) in grid.origins]
    return np.stack(parts, axis=1).reshape(-1, p, p, img.shape[-1])


@torch.no_grad()
def patch_parallel_sample_bucketed(gd, cond, mask, scfg, min_max_val: Tuple[float, float],
                                   patch: int, overlap: int = 0, noise=None,
                                   branched_noise=None) -> torch.Tensor:
    """Sparse-mask bucketing: a patch whose mask tile has no OOD pixel
    (binary mask >= 1.0 nowhere) runs the plain chain, one UNet row a step
    instead of the branched pair's two; the other patches run the branched
    chain.  Decided on the host from the mask (numpy, or a tensor read
    once).  The plain bucket draws from `noise` and the branched one from
    `branched_noise`, the JAX function's two keys (`kp`, `ko`), each a seed
    or a noise source; both are required.  Each bucket's draws are its own
    rows' only."""
    device = gd.device
    mask_np = (mask.detach().float().cpu().numpy() if isinstance(mask, torch.Tensor)
               else np.asarray(mask, np.float32))
    cond = _as_tensor(cond, device)
    b, h, w, _ = cond.shape
    grid = plan_patches(h, w, patch, overlap)
    mask_flat = _extract_patches_np(mask_np, grid)
    n = mask_flat.shape[0]
    has_ood = (mask_flat >= 1.0).reshape(n, -1).any(axis=1)
    ood_idx = np.nonzero(has_ood)[0]
    plain_idx = np.nonzero(~has_ood)[0]
    if noise is None or branched_noise is None:
        raise ValueError("the bucketed route needs noise and branched_noise, one a bucket")

    gd_patch = _patch_engine(gd, patch)
    cond_p = extract_patches(cond, grid)
    outs = torch.zeros_like(cond_p)
    if len(plain_idx):
        pi = torch.as_tensor(plain_idx, device=device)
        outs[pi] = _chain(gd_patch, cond_p[pi], None, scfg, min_max_val, noise, branched=False)
    if len(ood_idx):
        oi = torch.as_tensor(ood_idx, device=device)
        mask_p = torch.as_tensor(mask_flat[ood_idx], device=device)
        outs[oi] = _chain(gd_patch, cond_p[oi], mask_p, scfg, min_max_val, branched_noise,
                          branched=True)
    return stitch_patches(outs, grid, b, overlap)
