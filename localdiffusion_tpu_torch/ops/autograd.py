"""Gradients of the kernels: the backward of each kernel's
`torch.autograd.Function` recomputes through a plain reference.

The JAX package gives each Pallas kernel a `jax.custom_vjp` whose forward
keeps only its inputs and whose backward is `jax.vjp` of an XLA reference
(`_gn_vjp_bwd`, `_flash_bwd`, the linear attention's `_bwd`,
`_bwd_wfold`); it has no backward kernel.  The port does the same: a
Function saves its inputs, and `recompute_grads` differentiates the plain
PyTorch counterpart of that reference on them.

A kernel's launch function calls `refuse_graph` first: launched through
raw pointers, a kernel's output has no `grad_fn`, so a call that would
need one (grad enabled, an input requiring grad) raises instead of
dropping the graph.  Inside a Function's forward grad mode is off, so the
Functions launch the same kernels.
"""

from __future__ import annotations

import torch


def needs_graph(*tensors) -> bool:
    """Whether autograd would record a call on these tensors (None
    skipped): grad mode on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_graph(kernel: str, *tensors) -> None:
    """Raise where `kernel` would return an output cut from the graph."""
    if needs_graph(*tensors):
        raise RuntimeError(
            f"{kernel}: the kernel carries no gradient; call it under torch.no_grad(), or "
            "through its wrapper, whose autograd.Function recomputes the backward")


def recompute_grads(fn, inputs, needs_input_grad, grad_out) -> tuple:
    """The gradients of `fn(*inputs)` against `grad_out` for each input
    whose `needs_input_grad` is set, None for the others (and for None
    inputs): autograd through `fn` on detached aliases of the inputs."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs_input_grad)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad_out, allow_unused=True)
                     if wanted else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)
