"""Rematerialization to the second derivative: a call that keeps only its
inputs and recomputes itself in each backward (the JAX package's
``nn.remat`` around each block, models/backbone.py, and ``jax.checkpoint``
around the whole energy function, models/matpes.py ``inner_ckpt``).

Force training differentiates twice: the forces are a first backward kept
as a graph (``create_graph=True``), and the loss's backward differentiates
that graph.  ``torch.utils.checkpoint`` saves nothing there: its recompute
in the first backward builds the call's graph again, and the second
backward keeps it.  ``remat_call`` is a pair of autograd functions instead:

* ``_Remat``: the forward runs without a graph and saves the call's inputs
  and parameters.  Its backward recomputes the call and returns the VJP;
  when the backward itself is to be differentiated (the force pass), it
  returns the VJP through ``_RematVJP``.
* ``_RematVJP``: its forward recomputes the call and its VJP, keeps
  neither, and saves (inputs, parameters, cotangents); its backward
  recomputes call and VJP with a graph and differentiates that.

Between the force pass and the loss's backward a call so keeps its inputs,
cotangents and parameters only, and the loss's backward holds one call's
second-order graph at a time, as ``jax.checkpoint`` under nested ``grad``.
A backward wants a graph when grad mode is on as it starts: that is read
before the recompute turns grad mode on.

Each gradient is summed as in the step without remat: the force pass's
VJP is made with the graph-keeping formulas, as without remat, and in the
loss's backward a call's two nodes make one differentiation of the
recomputed call and its VJP.  On the CPU the numbers are the step's
without remat bit for bit.  On a GPU the autograd engine runs ready nodes
in the order of per-thread sequence numbers and the recomputes run on its
device thread, so a bfloat16 sum may take another order there, as it may
between a process's first steps and its later ones without remat.  Whichever of the two runs first, when the engine
will run the other later in the same backward, hands its cotangents over
and returns no input or parameter gradient (``_RematVJP`` still returns
its cotangents' gradients, which the backward needs to go on); the second
differentiates both.  A node that finds no partner in its backward (a
derivative taken from the forces alone) differentiates its part itself.

Inputs are tensors, None, tuples (named tuples too) and lists of them, and
objects whose tensor attributes are flattened (the Wigner containers); any
other value is a constant.  Integer tensors and tensors that need no
gradient get none.  The call draws its dropout masks from ``generator``:
the forward draws from it, so it stands after the call where it stands
without remat, and each recompute replays the forward's masks from a
private generator set to the state the forward started from (the device's
default generator when ``generator`` is None).  A recompute leaves the
tensor attributes of ``module``'s submodules (the MoE's routing entropy)
as it found them.  Called without grad, or with nothing that needs one,
``remat_call`` is a plain call.

The force pass also computes the VJP of every parameter, which it does
not use (a derivative by the positions only): autograd tells a
``Function`` which inputs require a gradient, not which ones this
backward is asked for.
"""

from __future__ import annotations

import copy
import weakref
from typing import Callable, Optional

import torch
import torch.nn as nn

__all__ = ["remat_call"]

_TENSOR = object()   # a leaf of the flattened inputs


def _flatten(obj, leaves: list):
    """The structure of ``obj``; its tensors go to ``leaves``."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _TENSOR
    if isinstance(obj, (tuple, list)):
        return (type(obj), [_flatten(o, leaves) for o in obj])
    attrs = {n: v for n, v in getattr(obj, "__dict__", {}).items()
             if isinstance(v, torch.Tensor)}
    if attrs and not isinstance(obj, nn.Module):
        return (copy.copy, obj, {n: _flatten(v, leaves) for n, v in attrs.items()})
    return (None, obj)


def _unflatten(spec, leaves):
    """``_flatten``'s object with its tensors taken from the iterator ``leaves``."""
    if spec is _TENSOR:
        return next(leaves)
    kind = spec[0]
    if kind is copy.copy:   # a shallow copy with the new tensors (caches stay shared)
        obj = copy.copy(spec[1])
        obj.__dict__.update({n: _unflatten(s, leaves) for n, s in spec[2].items()})
        return obj
    if kind is None:
        return spec[1]
    items = [_unflatten(s, leaves) for s in spec[1]]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator


class _Call:
    """``fn`` with its input structure, parameter names, random state and
    the module whose state a recompute must not change."""

    def __init__(self, fn, spec, names, n_in, generator, device, module):
        self.fn, self.spec, self.names, self.n_in = fn, spec, names, n_in
        self.generator = generator
        src = generator if generator is not None else _default_generator(device)
        self.rng_device, self.rng_state = src.device, src.get_state()
        self.module = module
        # the one differentiation of the loss's backward (module doc): the
        # _RematVJP node of the force pass, the graph task in which each node
        # last ran, and what each hands the other: (task, cotangents) from
        # _Remat, (task, cotangents, their gradients) from _RematVJP
        self.second = None
        self.ran_first = self.ran_second = None
        self.from_first: list = []
        self.from_second: list = []

    def __call__(self, flat, generator):
        inputs = _unflatten(self.spec, iter(flat[:self.n_in]))
        return tuple(self.fn(*inputs, dict(zip(self.names, flat[self.n_in:])), generator))

    def recompute(self, flat):
        """The call again, its dropout masks replayed, ``module``'s tensor
        attributes left as they were."""
        g = torch.Generator(device=self.rng_device)
        g.set_state(self.rng_state)
        kept = ([] if self.module is None else
                [(m, k, v) for m in self.module.modules() for k, v in vars(m).items()
                 if isinstance(v, torch.Tensor)])
        try:
            return self(flat, g)
        finally:
            for m, k, v in kept:
                m.__dict__[k] = v


def _leaves(tensors, needs, keep_graph: bool) -> list:
    """The recompute's inputs: the saved tensors, as leaves of a new graph,
    or as they are when a derivative of this backward follows."""
    if keep_graph:
        return list(tensors)
    return [t.detach().requires_grad_(True) if n else t for t, n in zip(tensors, needs)]


def _pairs(ys, gs) -> list:
    """(output, its gradient) where both are given and the output has a graph."""
    return [(y, g) for y, g in zip(ys, gs)
            if g is not None and isinstance(y, torch.Tensor) and y.requires_grad]


def _grad(pairs: list, tensors, needs, create_graph: bool = False) -> tuple:
    """The gradients of sum <y, g> over ``pairs`` by each of ``tensors``
    that ``needs`` one (None for the others)."""
    wrt = [t for t, n in zip(tensors, needs) if n]
    grads = iter(torch.autograd.grad([y for y, _ in pairs], wrt, [g for _, g in pairs],
                                     create_graph=create_graph, allow_unused=True)
                 if pairs and wrt else [None] * len(wrt))
    return tuple(next(grads) if n else None for n in needs)


def _vjp(call: _Call, flat: list, needs, cots, create_graph: bool) -> tuple:
    """The recomputed call's VJP with ``cots``; in grad mode."""
    return _grad(_pairs(call.recompute(flat), cots), flat, needs, create_graph)


def _joint(call: _Call, flat: list, needs, first: list, second: list,
           cot_leaves: list = (), cot_needs: tuple = ()) -> tuple:
    """One differentiation of the recomputed call and its VJP: ``first``
    holds cotangents on the call's outputs, ``second`` (cotangents,
    gradients) pairs, the gradients on the VJP by those cotangents.  Returns
    the gradients by ``flat`` and ``cot_leaves`` (the cotangents of
    ``second`` when they need theirs), each summed as the step without
    remat sums it; in grad mode."""
    outs = call.recompute(flat)
    pairs = [p for cots in first for p in _pairs(outs, cots)]
    for cots, ggrads in second:
        pairs += _pairs(_grad(_pairs(outs, cots), flat, needs, True), ggrads)
    return _grad(pairs, flat + list(cot_leaves), tuple(needs) + tuple(cot_needs))


def _will_run(node, ran, task: int) -> bool:
    """``node`` runs later in the backward ``task``."""
    return node is not None and ran != task and torch._C._will_engine_execute_node(node)


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call: _Call, *flat):
        ctx.set_materialize_grads(False)
        ctx.call = call
        ctx.save_for_backward(*flat)
        return call(list(flat), call.generator)

    @staticmethod
    def backward(ctx, *cots):
        create = torch.is_grad_enabled()   # a graph of this backward is wanted
        needs = ctx.needs_input_grad[1:]
        saved, call = ctx.saved_tensors, ctx.call
        if create:
            return (None, *_RematVJP.apply(call, ctx, len(saved), needs, *saved, *cots))
        task = call.ran_first = torch._C._current_graph_task_id()
        second = [(c, g) for t, c, g in call.from_second if t == task]
        call.from_second = []
        if not second and _will_run(call.second and call.second(), call.ran_second, task):
            call.from_first.append((task, cots))   # _RematVJP differentiates both
            return (None,) * (1 + len(saved))
        with torch.enable_grad():
            flat = _leaves(saved, needs, False)
            if second:
                return (None, *_joint(call, flat, needs, [cots], second))
            return (None, *_vjp(call, flat, needs, cots, False))


class _RematVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call: _Call, first, n: int, needs: tuple, *args):
        ctx.set_materialize_grads(False)
        ctx.call, ctx.first, ctx.n, ctx.needs = call, first, n, needs
        call.second = weakref.ref(ctx)
        ctx.save_for_backward(*args)
        with torch.enable_grad():   # the VJP the force pass would make without remat
            grads = _vjp(call, _leaves(args[:n], needs, False), needs, args[n:], True)
        return tuple(None if g is None else g.detach() for g in grads)

    @staticmethod
    def backward(ctx, *ggrads):
        create = torch.is_grad_enabled()   # a third derivative follows
        args, n, call = ctx.saved_tensors, ctx.n, ctx.call
        cneeds = ctx.needs_input_grad[4 + n:]
        none = (None,) * 4
        with torch.enable_grad():
            flat = _leaves(args[:n], ctx.needs, create)
            cots = _leaves(args[n:], cneeds, create)
            if create:
                grads = _vjp(call, flat, ctx.needs, cots, True)
                return none + _grad(_pairs(grads, ggrads), flat + cots, ctx.needs + cneeds,
                                    True)
            task = call.ran_second = torch._C._current_graph_task_id()
            first = [c for t, c in call.from_first if t == task]
            call.from_first = []
            if first:
                return none + _joint(call, flat, ctx.needs, first, [(cots, ggrads)], cots,
                                     cneeds)
            # _Remat differentiates both when it runs later: only the
            # cotangents' gradients here
            hand = _will_run(ctx.first, call.ran_first, task)
            if hand:
                call.from_second.append((task, [None if c is None else c.detach()
                                                 for c in args[n:]], ggrads))
            needs = ((False,) * n if hand else ctx.needs) + cneeds
            grads = _vjp(call, flat, ctx.needs, cots, True)
            return none + _grad(_pairs(grads, ggrads), flat + cots, needs)


def remat_call(fn: Callable, inputs: tuple, params: dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               module: Optional[nn.Module] = None) -> tuple:
    """``fn(*inputs, params, generator)`` (a tuple of tensors or None),
    rematerialized in every backward (module doc).  ``params``: a name ->
    tensor mapping that ``fn`` computes with; gradients reach the tensors
    given (e.g. bfloat16 copies, and through them their float32 masters)."""
    flat: list = []
    spec = _flatten(tuple(inputs), flat)
    names = list(params)
    flat_all = flat + [params[n] for n in names]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in flat_all)):
        return tuple(fn(*inputs, params, generator))
    device = next(t.device for t in flat_all)
    call = _Call(fn, spec, names, len(flat), generator, device, module)
    return _Remat.apply(call, *flat_all)
