"""Training: EMA, clip + Adam, the three step modes, checkpoints.

Port of `localdiffusion_tpu/train/trainer.py`, on one device:

  * the EMA copy follows ema_pytorch's warm-up (`EmaConfig`,
    `ema_decay_for_step`), updated every `update_every` steps;
  * the optimizer is optax's `clip_by_global_norm` then Adam(lr, β = (0.9,
    0.99), eps 1e-8): the clip is written out with optax's formula, Adam is
    `torch.optim.Adam`, which computes the same update; parameters, their
    gradients and the optimizer's state stay float32 whatever the compute
    type;
  * three steps: one batch (`train_batch_step`), an epoch of streamed
    batches accumulated into one step (`train_epoch_step`, the reference's
    full-dataset accumulation), and the same over a dataset that lives on
    the device (`train_epoch_resident`, drop-last, the permutation drawn on
    the device);
  * every forward and backward runs inside `utils.precision.full_float32`:
    cuDNN and cuBLAS read the TF32 flags when the backward launches them;
  * a checkpoint is one file, `model-<milestone>.pt` under
    `results_dir/project_name`, holding the step, the parameters, the
    optimizer's state and the EMA, written to a temporary file and then
    renamed into place.  The JAX package writes Orbax directories, which the
    card's machine cannot read or write (no Orbax there); this format is the
    port's own.  `utils.params_io.save_params_npz` writes the EMA as the
    slim npz that both packages load.

Data parallelism (`mesh`, a `parallel.mesh.make_mesh` of the process
group): every rank is given the same global batch and its draws and keeps
its rows (`parallel.multihost.row_range`); each rank's loss is weighted by
its share, the gradients are averaged over the ranks (an all-reduce, or
with `fsdp=True` FSDP2's reduce-scatter) to the global batch's gradient
before the clip, so a step on any number of ranks takes the one-process
step's values.  With `fsdp=True` the parameters, their gradients, Adam's
moments and the EMA are sharded over the ranks (`parallel.fsdp`), and no
rank holds an unsharded copy of any of them: the EMA samples through the
model's own units with its shards copied in for the chain.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from dataclasses import dataclass, replace
from typing import Iterable, Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.config import TrainConfig
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, as_draws
from localdiffusion_tpu_torch.diffusion.sampler import as_noise, ddpm_sample_plain
from localdiffusion_tpu_torch.parallel import fsdp as F
from localdiffusion_tpu_torch.parallel import multihost
from localdiffusion_tpu_torch.utils.precision import full_float32


@dataclass(frozen=True)
class EmaConfig:
    beta: float = 0.995
    update_every: int = 10
    update_after_step: int = 100
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0


def ema_decay_for_step(step: int, cfg: EmaConfig) -> float:
    """ema_pytorch's warm-up decay, in float32 as the JAX package computes
    it: 0 until `update_after_step`, then clamp(1 − (1 + s/inv_gamma)^−power,
    min_value, beta) with s = max(step − update_after_step − 1, 0)."""
    if step <= cfg.update_after_step:
        return 0.0
    f = np.float32
    s = f(max(step - cfg.update_after_step - 1, 0))
    value = f(1.0) - (f(1.0) + s / f(cfg.inv_gamma)) ** f(-cfg.power)
    return float(np.clip(value, f(cfg.min_value), f(cfg.beta)))


@torch.no_grad()
def ema_update(ema_params, params, step: int, cfg: EmaConfig) -> None:
    """e ← e·d + p·(1 − d) in place, d = `ema_decay_for_step(step)`, on the
    steps where step % update_every == 0; the EMA is left as it is on the
    others."""
    if step % cfg.update_every:
        return
    decay = np.float32(ema_decay_for_step(step, cfg))
    ema_params, params = [F.local(e) for e in ema_params], [F.local(p) for p in params]
    torch._foreach_mul_(ema_params, float(decay))
    torch._foreach_add_(ema_params, torch._foreach_mul(params, float(np.float32(1.0) - decay)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, group=None) -> torch.Tensor:
    """optax's `clip_by_global_norm`, in place: where the global norm ‖g‖
    (over every gradient) reaches max_norm, each g becomes g / ‖g‖ ·
    max_norm; below it g is left as it is.  No epsilon is added to the norm
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6).  The choice is made on the
    device, so the step waits for no copy to the host.  Returns ‖g‖.

    Sharded gradients (DTensors) hold a shard each: their squares are
    summed over the ranks of `group` before the root, so every rank clips
    by the whole gradient's norm."""
    grads = [F.local(g) for g in grads]
    sq = sum((g.float() * g.float()).sum() for g in grads)
    if group is not None:
        sq = _all_reduce_sum(sq, group)
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full((), float(max_norm), device=norm.device))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of `group`, on t's device."""
    import torch.distributed as dist

    buf = t.to(multihost.collective_device(group))
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam(lr, β = (adam_b1, adam_b2), eps 1e-8), optax's `adam` (eps_root
    0); the clip runs before it in `Trainer._apply`."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)


def optax_adam(params, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)` with optax's defaults, β = (0.9, 0.999) and eps 1e-8
    (the aux models' scripts train with it, no clip)."""
    return make_optimizer(params, replace(TrainConfig(), lr=lr, adam_b1=0.9, adam_b2=0.999))


class RowDraws(multihost.RowsNoise):
    """The loss's draws for rows [lo, hi) of an n-row global batch: each
    draw of the batch's rows is taken for all n and the rank's rows kept
    (`multihost.RowsNoise`); a permutation and the self-conditioning coin
    are the whole batch's.  So every rank draws what one process draws for
    its rows."""

    def __init__(self, draws, n: int, lo: int, hi: int):
        self.draws = as_draws(draws)
        super().__init__(self.draws.normal, n, slice(lo, hi))

    def timesteps(self, b: int, num_timesteps: int) -> torch.Tensor:
        self.check(b)
        return self.keep(self.draws.timesteps(self.n, num_timesteps))

    def normal(self, shape) -> torch.Tensor:
        return self(shape)

    def permutation(self, n: int) -> torch.Tensor:
        return self.draws.permutation(n)

    def coin(self) -> bool:
        return self.draws.coin()


class Trainer:
    """Trains the UNet of `gd` in place on its device.

    It holds the step, the optimizer over the parameters that take a
    gradient (`params`), and `ema_model`, a copy of the whole UNet with its
    own storage on the same device; `ema_gd` is an engine that
    samples with it.  Each step's random numbers come from the `draws`
    given to it (a `torch.Generator` on the device, or
    `diffusion.gaussian.ArrayDraws`).

    With `mesh` (`parallel.mesh.make_mesh`, one rank a device), the ranks
    of its 'data' axis share every step: each is given the global batch
    and its draws, keeps its rows and its draws' rows (`RowDraws`), and
    the gradients are averaged to the global batch's before the clip.
    `fsdp=True` shards the UNet and the EMA with `parallel.fsdp`; the
    EMA's chains run through the model's units (`_ema_engine`)."""

    def __init__(self, gd: GaussianDiffusion, cfg: TrainConfig, ema_cfg: EmaConfig = EmaConfig(),
                 mesh=None, fsdp: bool = False):
        self.gd = gd
        self.cfg = cfg
        self.ema_cfg = ema_cfg
        self.mesh = mesh
        self.fsdp = bool(fsdp)
        if self.fsdp and mesh is None:
            raise ValueError("fsdp=True requires a mesh")
        self.group = mesh.get_group("data") if mesh is not None else None
        self.model = gd.model
        if any(p.dtype != torch.float32 for p in self.model.parameters()):
            raise TypeError("the trained parameters must be float32")
        self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        self.ema_gd = copy.copy(gd)
        if self.fsdp:
            F.shard_model(self.model, mesh["data"])
            F.shard_model(self.ema_model, mesh["data"])
            # the EMA's shards are sampled through the model's units
            self.ema_gd.model = self.model
        else:
            self.ema_gd.model = self.ema_model
        # what the optimizer and the clip see: random Fourier features' frozen
        # weights take no gradient (the JAX module's stop_gradient: Adam, and
        # the EMA of an unchanged value, leave them as they are)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.params, cfg)
        self.step = 0
        self.results_dir = os.path.join(cfg.results_dir, cfg.project_name)

    @property
    def data_parallel(self) -> bool:
        return self.group is not None and multihost.is_multiprocess()

    def reset_ema(self) -> None:
        """EMA ← the current parameters (a warm start's `--init-npz`)."""
        with torch.no_grad():
            for e, p in zip(self.ema_model.parameters(), self.model.parameters()):
                F.local(e).copy_(F.local(p))

    def load_params(self, state_dict) -> None:
        """Full (unsharded) parameters into the model, sharded or not."""
        F.load_full(self.model, state_dict)

    def _as_tensors(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.gd.device) for a in arrays)

    def _rows(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of an n-row global batch."""
        import torch.distributed as dist

        lo, hi = multihost.row_range(n, dist.get_rank(self.group),
                                     dist.get_world_size(self.group))
        if hi <= lo:
            raise ValueError(f"a batch of {n} rows leaves rank {dist.get_rank(self.group)} "
                             f"no row")
        return lo, hi

    def _accumulate(self, batches: Iterable[Tuple], n: int, draws) -> torch.Tensor:
        """Σ over the batches of ∇(loss/n) into the parameters' `.grad`, in
        batch order; returns Σ loss/n (a device scalar).  Across ranks each
        batch is the global one: a rank's loss on its rows is weighted by
        rows·ranks/batch, so the ranks' average gradient is the global
        batch's; the loss returned is the global one."""
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.gd.device)
        with full_float32():
            for hr, lr in batches:
                weight = 1.0
                batch_draws = draws
                if self.data_parallel:
                    b, world = len(hr), self.group.size()
                    lo, hi = self._rows(b)
                    hr, lr = hr[lo:hi], lr[lo:hi]
                    weight = (hi - lo) * world / b
                    batch_draws = RowDraws(draws, b, lo, hi)
                hr, lr = self._as_tensors(hr, lr)
                loss = self.gd.loss(hr, lr, batch_draws) * (weight / n)
                loss.backward()
                total = total + loss.detach()
        if self.data_parallel:
            total = _all_reduce_sum(total, self.group) / self.group.size()
            if not self.fsdp:
                self._average_grads()
        return total

    @torch.no_grad()
    def _average_grads(self) -> None:
        """Replicated data parallelism: every gradient averaged over the
        ranks (one all-reduce of the flattened gradients)."""
        import torch.distributed as dist
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        flat = _flatten_dense_tensors(grads).to(multihost.collective_device(self.group))
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.group.size())
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)

    def _apply(self) -> None:
        """Clip, Adam, step + 1, then the EMA of the new step."""
        clip_by_global_norm([p.grad for p in self.params], self.cfg.max_grad_norm,
                            group=self.group if self.fsdp and self.data_parallel else None)
        self.optimizer.step()
        self.step += 1
        ema_update(self.ema_model.parameters(), self.model.parameters(), self.step, self.ema_cfg)

    def train_batch_step(self, hr, lr, draws) -> float:
        """One optimizer step on one batch (NHWC arrays or tensors); returns
        its loss."""
        loss = self._accumulate([(hr, lr)], 1, draws)
        self._apply()
        return float(loss)

    def train_epoch_step(self, batches: Iterable[Tuple], draws) -> float:
        """One optimizer step over an epoch of (hr, lr) batches: each
        batch's loss scaled by 1/n, n the number of batches (a short last
        batch counts as one), the gradients summed.  Returns Σ loss/n."""
        batches = list(batches)
        loss = self._accumulate(batches, len(batches), draws)
        self._apply()
        return float(loss)

    def train_epoch_resident(self, data_hr: torch.Tensor, data_lr: torch.Tensor, draws) -> float:
        """One optimizer step over a dataset on the device: a permutation of
        its n rows drawn from `draws` on the device, nb = n // batch_size
        microbatches of its first nb·batch_size entries (drop-last), each
        gathered on the device, accumulated as `train_epoch_step` does."""
        draws = as_draws(draws)
        n, bs = data_hr.shape[0], self.cfg.batch_size
        nb = n // bs
        if nb < 1:
            raise ValueError(f"{n} rows make no batch of {bs}")
        for name, t in (("data_hr", data_hr), ("data_lr", data_lr)):
            if t.device.type != self.gd.device.type or t.shape[0] != n:
                raise ValueError(f"{name} must hold {n} rows on {self.gd.device}, "
                                 f"got {tuple(t.shape)} on {t.device}")
        perm = draws.permutation(n)[: nb * bs]
        batches = ((data_hr[i], data_lr[i]) for i in perm.reshape(nb, bs))
        loss = self._accumulate(batches, nb, draws)
        self._apply()
        return float(loss)

    @contextlib.contextmanager
    def _ema_engine(self):
        """The engine that samples with the EMA.  Under FSDP the EMA's shards
        are copied into the model's for the block and the model's own put
        back after: each unit all-gathers the EMA as it runs (collective:
        every rank makes the same calls), and no rank holds an unsharded
        copy.  FSDP2 keeps the root unit gathered after a forward; it is
        resharded before the model's shards return."""
        if not self.fsdp:
            yield self.ema_gd
            return
        self.model.reshard()
        mine = [F.local(p) for p in self.model.parameters()]
        with torch.no_grad():
            saved = [t.clone() for t in mine]
            torch._foreach_copy_(mine, [F.local(e) for e in self.ema_model.parameters()])
        try:
            yield self.ema_gd
        finally:
            self.model.reshard()
            with torch.no_grad():
                torch._foreach_copy_(mine, saved)

    def ema_state_dict(self) -> dict:
        """The EMA's full (unsharded) state dict, as one process holds it
        (collective under FSDP: every rank calls it)."""
        return F.gather_tree(self.ema_model)

    def state_tensors(self) -> list:
        """Every tensor of the training state this rank holds: the model's
        parameters and buffers, their gradients, the optimizer's state and
        the EMA's parameters and buffers (shards under FSDP); what
        `parallel.fsdp.shard_info` measures."""
        opt = [v for st in self.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor)]
        return [*self.model.parameters(), *self.model.buffers(),
                *(p.grad for p in self.model.parameters() if p.grad is not None), *opt,
                *self.ema_model.parameters(), *self.ema_model.buffers()]

    def eval_sample_mse(self, hr, lr, noise, min_max_val=None) -> float:
        """MSE of the EMA model's plain DDPM chain (`ddpm_sample_plain`, T
        steps from the condition `lr`) against `hr`.  min_max_val is
        required: the clip range depends on the data
        (`config.min_max_val_for`).  Across ranks each samples its rows of
        the batch (its noise the rows of the whole batch's draws) and the
        squared errors are summed over the ranks."""
        if min_max_val is None:
            raise ValueError("eval_sample_mse requires min_max_val "
                             "(use localdiffusion_tpu_torch.config.min_max_val_for)")
        if not self.data_parallel:
            hr, lr = self._as_tensors(hr, lr)
            with self._ema_engine() as gd:
                out = ddpm_sample_plain(gd, lr, min_max_val, noise=noise)
            return float(((out - hr) ** 2).mean())
        b = len(hr)
        lo, hi = self._rows(b)
        hr, lr = self._as_tensors(hr[lo:hi], lr[lo:hi])
        rows = multihost.RowsNoise(as_noise(noise, self.gd.device), b, slice(lo, hi))
        with self._ema_engine() as gd:
            out = ddpm_sample_plain(gd, lr, min_max_val, noise=rows)
        sq, count = multihost.sum_over([float(((out - hr).double() ** 2).sum()), out.numel()],
                                       self.group)
        return sq / count

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def checkpoint_path(self, milestone: str) -> str:
        return os.path.join(self.results_dir, f"model-{milestone}.pt")

    def save(self, milestone: str) -> str:
        """Write the step, parameters, optimizer state and EMA to
        `model-<milestone>.pt`, atomically; returns the path.  Across ranks
        every rank gathers the sharded state (collective), the primary
        alone writes it, and all meet at a barrier after: the file is the
        one-process layout, whatever the number of ranks."""
        path = self.checkpoint_path(milestone)
        state = dict(step=self.step, params=F.gather_tree(self.model),
                     optimizer=F.full_optimizer_state(self.optimizer),
                     ema=F.gather_tree(self.ema_model))
        if multihost.is_primary():
            os.makedirs(self.results_dir, exist_ok=True)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
        multihost.sync("save")
        return path

    def load(self, milestone: str) -> None:
        """Restore what `save` wrote onto this trainer's device (read on the
        host first, so that Adam's step counts stay where Adam keeps them);
        every rank reads the file and, under FSDP, keeps its shards."""
        state = torch.load(self.checkpoint_path(milestone), map_location="cpu",
                           weights_only=True)
        if self.fsdp:
            F.load_full(self.model, state["params"])
            F.load_full(self.ema_model, state["ema"])
            F.load_full_optimizer_state(self.optimizer, state["optimizer"], tuple(self.params))
        else:
            self.model.load_state_dict(state["params"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.ema_model.load_state_dict(state["ema"])
        self.step = int(state["step"])


def round_milestone(step: int) -> str:
    """Rounded milestone names (reference ddpm.py:1529-1530 round_num)."""
    if step < 100:
        return str(step)
    return str(int(round(step / 100.0) * 100))


def load_best_eval(results_dir: str) -> float:
    """Best eval metric recorded by any previous run in results_dir."""
    path = os.path.join(results_dir, "best_eval.json")
    try:
        with open(path) as f:
            return float(json.load(f)["best"])
    except (OSError, ValueError, KeyError):
        return float("inf")


def record_best_eval(results_dir: str, value: float, milestone: str) -> None:
    """Atomically persist the new best eval metric + its milestone name."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, "best_eval.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"best": float(value), "milestone": milestone}, f)
    os.replace(tmp, path)
