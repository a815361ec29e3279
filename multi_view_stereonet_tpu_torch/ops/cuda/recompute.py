"""The backward of K3: recompute through the plain version.

Each Pallas kernel of the JAX package sits under a ``jax.custom_vjp`` whose
forward saves the kernel's inputs and whose backward takes ``jax.vjp`` of the
plain XLA function (``ops/pallas/gn_apply.py:99-127``,
``incremental_chain.py:335-371``, ``refiner_kernel.py:227-255``,
``warp_kernel.py:385-407``). The port does the same for K3 (``refiner.py``
``_IdepthmapRefiner``): its forward launches the kernel and saves the inputs; its
backward recomputes the plain PyTorch version on detached copies under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` for each input that needs
one. The recompute runs the plain versions all the way down, so it launches no kernel.
K1, K2 and K4 have backward kernels of their own, each counted in its module's
``backward_launches`` (``warp.py`` ``grid_sample_backward``, ``incremental_chain.py``
``incremental_chain_backward``, ``gn_apply.py`` ``group_norm_act_backward``); every
``launches`` counter counts forwards only.
"""

from __future__ import annotations

import torch


def needs_autograd(*tensors) -> bool:
    """True when grad mode is on and any of ``tensors`` (None skipped) requires grad:
    the wrappers then go through their Function, and launch the kernel directly
    otherwise."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def bind_parameters(module: torch.nn.Module, names, params):
    """``module`` as a callable that runs with ``params`` in place of its parameters of
    those ``names`` (``torch.func.functional_call``), so that the recompute
    differentiates with respect to the tensors a Function was given."""
    table = dict(zip(names, params))
    return lambda *args, **kwargs: torch.func.functional_call(module, table, args, kwargs)


def plain_vjp(plain, inputs, needs_input_grad, grad_outputs) -> tuple:
    """The gradients of ``plain(*inputs)`` with respect to each input whose
    ``needs_input_grad`` is set, given the gradients of its outputs (None where an
    output got none); None for every other input."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs_input_grad)]
        outputs = plain(*leaves)
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        pairs = [(o, g) for o, g in zip(outputs, grad_outputs)
                 if g is not None and o.requires_grad]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        if not pairs or not wanted:
            return (None,) * len(leaves)
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                         [g for _, g in pairs], allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)
