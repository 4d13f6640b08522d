"""Training harness of the MatPES force-training step and the QM9 step:
guarded AdamW, EMA, mixed precision, losses.

Port of the JAX package's train/trainer.py (the MatPES and QM9 parts):

* ``GuardedAdamW``: one global-norm reduction over all gradients feeds both
  the clip scale ``min(1, clip / |g|)`` and the skip decision; a non-finite
  norm skips the update and freezes the AdamW moments and the schedule
  count, keeping ``notfinite_count``, ``total_notfinite`` and
  ``last_finite`` (the JAX package's ``_guarded_clip_adamw``).  The AdamW
  update is ``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8), the same
  arithmetic as ``optax.adamw``; weight decay applies where ``decays`` says
  (the JAX package's ``_wd_mask``).  The learning rate of an update is
  ``schedule(number of accepted updates so far)``, optax's count.  The
  finiteness test reads the norm on the host: one synchronisation a step.
  Updates are skipped for as long as the norm stays non-finite (the JAX
  package's ``make_optimizer`` sets no practical limit either).
* ``ema_update`` after every step (decay 0.999), as the JAX step does.
* ``cast_params``: bfloat16 copies of every float parameter, called through
  ``torch.func.functional_call``, so gradients land on the float32 masters.
* ``matpes_loss``: L1 on per-atom energy + masked L1 on forces (+ L1 on
  the Voigt stress when ``w_stress > 0``).
* ``make_matpes_train_step``: forces (and, with ``w_stress > 0``, the
  per-graph stress) by autograd with ``create_graph=True``, so the loss
  backward is a grad-of-grad through every kernel (rematerialized per
  block with the model's ``remat``, and as a whole with ``inner_ckpt``:
  nn/remat.py); the step
  computes in the model's ``compute_dtype`` (bfloat16: through
  ``cast_params``); TF32 is off inside each step (the geometry is float32).
* ``qm9_loss`` / ``make_qm9_train_step``: L1 (or MSE) on the normalized
  targets, one first-order backward, the same optimizer, EMA and
  precision rules (float32 unless the model computes in bfloat16, as in
  the JAX package, whose ``mixed_precision`` is off by default).
* ``oc20_loss`` / ``make_oc20_train_step``: E-MSE x 2 + F-L1 x 100 on the
  energy head and the explicit force head (no derivative of the energy),
  one first-order backward, the same optimizer, EMA and precision rules.
* Each step is two halves, which ``parallel/data_parallel.py`` runs with a
  gradient all-reduce between them: ``*_loss_grad`` (the loss, its
  gradients in the masters' ``.grad``) and ``apply_updates`` (the guarded
  AdamW, the EMA, ``state.step``).
* Sharded state (``parallel/sharding.py:shard_state``, tensor / expert
  parallelism): the optimizer's ``model_group`` and ``sharded`` flags make
  the global norm sum the squared norms of the shards over the ``model``
  group and count each replicated leaf once, so the guard takes or skips a
  step on every rank alike; ``TrainState.state_dict()`` gathers the whole
  state and ``load_state_dict`` takes a whole one and keeps this rank's
  share (every rank of the group must call them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch
import torch.nn as nn

from ..models.matpes import matpes_energy_forces
from ..utils.precision import full_f32_products

__all__ = ["decays", "wd_mask", "GuardedAdamW", "TrainState", "create_train_state",
           "ema_update", "cast_params", "apply_updates", "matpes_loss", "matpes_loss_grad",
           "make_matpes_train_step", "qm9_loss", "qm9_loss_grad", "make_qm9_train_step",
           "oc20_loss", "oc20_loss_grad", "make_oc20_train_step"]


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies: >=2-D matrices named 'weight', outside
    embeddings and norms (the JAX package's ``_wd_mask`` on its names)."""
    low = name.lower()
    return (p.dim() >= 2 and "embed" not in low and "norm" not in low
            and name.rsplit(".", 1)[-1] == "weight")


def wd_mask(model: nn.Module) -> dict[str, bool]:
    return {n: decays(n, p) for n, p in model.named_parameters()}


class GuardedAdamW:
    """Global-norm clip + non-finite skip + masked AdamW (see module doc)."""

    def __init__(self, named_parameters: Iterable[tuple[str, nn.Parameter]],
                 schedule: Callable[[int], float], weight_decay: float = 0.0,
                 grad_clip: float = 1.0):
        named = [(n, p) for n, p in named_parameters if p.requires_grad]
        self.params = [p for _, p in named]
        groups = [
            dict(params=[p for n, p in named if decays(n, p)], weight_decay=weight_decay),
            dict(params=[p for n, p in named if not decays(n, p)], weight_decay=0.0),
        ]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0            # accepted updates: the schedule's step
        self.notfinite_count = 0  # consecutive non-finite steps
        self.total_notfinite = 0
        self.last_finite = True
        self.model_group = None   # parallel/sharding.py:ModelGroup of a sharded state
        self.sharded: list[bool] = []

    def _global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if self.model_group is None:
            return torch.linalg.vector_norm(norms)
        sq = norms * norms
        mine = torch.as_tensor(self.sharded, device=sq.device)
        shards = self.model_group.reduce_from(sq[mine].sum())   # every rank's shards
        return torch.sqrt(sq[~mine].sum() + shards)

    def step(self) -> dict:
        """Apply one update from the parameters' ``.grad``; returns the
        global norm (a tensor), the learning rate used and whether the
        update was applied."""
        for p in self.params:
            if p.grad is None:  # unused this step: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        gnorm = self._global_norm(grads)
        finite = bool(torch.isfinite(gnorm))  # the step's one host sync
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        self.last_finite = finite
        lr = self.schedule(self.count)
        if finite:
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            torch._foreach_mul_(grads, scale)
            for g in self.opt.param_groups:
                g["lr"] = lr
            self.opt.step()
            self.count += 1
        return {"grad_norm": gnorm.detach(), "lr": lr, "accepted": finite}

    def state_dict(self) -> dict:
        return {"adamw": self.opt.state_dict(), "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "last_finite": self.last_finite}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["adamw"])
        self.count = int(sd["count"])
        self.notfinite_count = int(sd["notfinite_count"])
        self.total_notfinite = int(sd["total_notfinite"])
        self.last_finite = bool(sd["last_finite"])


@dataclass
class TrainState:
    """Model (float32 masters), optimizer, EMA of the parameters, step;
    ``mesh``: the ``parallel/sharding.py:CompositeMesh`` or
    ``parallel/pipeline.py:PipeMesh`` of a sharded state (None: whole)."""

    model: nn.Module
    optimizer: GuardedAdamW
    ema: dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0
    mesh: object = None

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.sharded

    def state_dict(self) -> dict:
        if self._sharded():
            return self.mesh.gather_state(self)
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "ema": self.ema, "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        if self._sharded():
            self.mesh.load_full_state(self, sd)
            return
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        for k, v in sd["ema"].items():
            self.ema[k].copy_(v)
        self.step = int(sd["step"])


def create_train_state(model: nn.Module, optimizer: GuardedAdamW) -> TrainState:
    """The EMA starts as a copy of the parameters."""
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, optimizer, ema)


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.999):
    """ema = ema * decay + p * (1 - decay), in place."""
    names = list(ema)
    params = dict(model.named_parameters())
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names], alpha=1.0 - decay)


def cast_params(model: nn.Module, dtype: torch.dtype,
                params: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """Compute copies of the float parameters (mixed precision: f32
    masters, bf16 compute) of the model, or of ``params`` (e.g. the EMA
    weights) when given; gradients flow back through the casts."""
    named = model.named_parameters() if params is None else params.items()
    return {n: p.to(dtype) if p.is_floating_point() else p for n, p in named}


def matpes_loss(outs: dict, batch: dict, w_energy: float = 1.0, w_force: float = 1.0,
                w_stress: float = 0.0):
    """L1 on per-atom energy + L1 on forces over real atoms (reference
    train_MatPES_GATAWandB.py:79-81), + ``w_stress`` x L1 on the stress
    when ``w_stress > 0`` and the outputs carry one (``stress_l1``)."""
    e_pred = outs["energy"][:, 0].float()
    e_l1 = torch.mean(torch.abs(e_pred - batch["energy"]))
    mask = batch["node_mask"]
    m = mask[:, None].to(e_pred.dtype)
    f_l1 = torch.sum(torch.abs(outs["forces"] - batch["forces"]) * m) / torch.clamp(
        3.0 * mask.sum(), min=1.0)
    loss = w_energy * e_l1 + w_force * f_l1
    metrics = {"energy_l1": e_l1, "force_l1": f_l1}
    if w_stress > 0.0 and "stress" in outs:
        s_l1 = torch.mean(torch.abs(outs["stress"] - batch["stress"]))
        loss = loss + w_stress * s_l1
        metrics["stress_l1"] = s_l1
    return loss, metrics


def apply_updates(state: TrainState, ema_decay: float = 0.999) -> dict:
    """The update half of a step (the JAX package's
    ``parallel/data_parallel.py:_apply_updates_factory``): the guarded AdamW
    from the parameters' ``.grad``, then the EMA and ``state.step``.
    Returns the optimizer's info (grad_norm, lr, accepted)."""
    with full_f32_products():
        info = state.optimizer.step()
        ema_update(state.ema, state.model, ema_decay)
    state.step += 1
    return info


def _train_step(state: TrainState, loss_grad: Callable, ema_decay: float):
    """``step(batch) -> (loss, metrics)``: ``loss_grad`` then ``apply_updates``."""

    def step(batch: dict):
        loss, metrics = loss_grad(batch)
        info = apply_updates(state, ema_decay)
        return loss, {**metrics, "loss": loss, **info}

    return step


def matpes_loss_grad(state: TrainState, w_energy: float = 1.0, w_force: float = 1.0,
                     w_stress: float = 0.0, generator: torch.Generator | None = None,
                     cast: bool = True, inner_ckpt: bool = False):
    """``loss_grad(batch) -> (loss, metrics)``, the gradient half of the
    MatPES step: the loss's gradients land in the float32 masters' ``.grad``
    (None where a parameter is unused).  See ``make_matpes_train_step``.
    ``cast=False`` keeps the float32 parameters in the forward of a
    bfloat16 model (the JAX package's composite step); ``inner_ckpt``:
    ``models/matpes.py:matpes_energy_forces``'s."""
    model = state.model
    cdt = model.backbone.compute_dtype

    def loss_grad(batch: dict):
        model.train()
        with full_f32_products():
            model.zero_grad(set_to_none=True)
            params = cast_params(model, cdt) if cast and cdt != torch.float32 else None
            outs = matpes_energy_forces(model, batch, create_graph=True, params=params,
                                        generator=generator, regress_stress=w_stress > 0.0,
                                        inner_ckpt=inner_ckpt)
            loss, metrics = matpes_loss(outs, batch, w_energy, w_force, w_stress)
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return loss_grad


def make_matpes_train_step(state: TrainState, w_energy: float = 1.0,
                           w_force: float = 1.0, w_stress: float = 0.0,
                           ema_decay: float = 0.999,
                           generator: torch.Generator | None = None,
                           inner_ckpt: bool = False):
    """``step(batch) -> (loss, metrics)``, updating ``state`` in place.

    The model runs in ``train()`` mode (dropout masks from ``generator``).
    A model built with ``compute_dtype=torch.bfloat16`` computes with
    bfloat16 copies of its float32 master weights.  A step whose gradient
    norm is not finite applies no update (``metrics["accepted"]`` is
    False); the EMA and ``state.step`` move every step, as in the JAX
    package.  ``w_stress > 0`` takes the per-graph stress path
    (``models/matpes.py:matpes_energy_forces_stress_pergraph``) and adds
    the stress term to the loss.  ``inner_ckpt`` rematerializes the whole
    energy evaluation in the loss's backward (the JAX package's argument;
    a model built with ``remat`` rematerializes each block).  The step is
    ``matpes_loss_grad`` followed by ``apply_updates``.
    """
    return _train_step(state, matpes_loss_grad(state, w_energy, w_force, w_stress, generator,
                                               inner_ckpt=inner_ckpt), ema_decay)


def qm9_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    """pred / target [B, T]; the mean over molecules and targets."""
    d = pred.float() - target
    return d.abs().mean() if kind == "l1" else (d * d).mean()


def _forward(model: nn.Module, batch: dict, generator: torch.Generator | None):
    """The model's output, on bfloat16 copies of the masters when the model
    computes in bfloat16."""
    cdt = model.backbone.compute_dtype
    if cdt == torch.float32:
        return model(batch, generator=generator)
    return torch.func.functional_call(model, cast_params(model, cdt), (batch,),
                                      dict(generator=generator))


def qm9_loss_grad(state: TrainState, loss_kind: str = "l1",
                  generator: torch.Generator | None = None):
    """``loss_grad(batch) -> (loss, metrics)``, the gradient half of the QM9
    step (see ``make_qm9_train_step``)."""
    model = state.model

    def loss_grad(batch: dict):
        model.train()
        with full_f32_products():
            model.zero_grad(set_to_none=True)
            loss = qm9_loss(_forward(model, batch, generator), batch["y"], loss_kind)
            loss.backward()
        return loss.detach(), {}

    return loss_grad


def make_qm9_train_step(state: TrainState, loss_kind: str = "l1", ema_decay: float = 0.999,
                        generator: torch.Generator | None = None):
    """``step(batch) -> (loss, metrics)`` for ``models/qm9.py:EquiformerV2QM9``,
    updating ``state`` in place (the JAX package's ``make_qm9_train_step``).

    The model runs in ``train()`` mode (dropout masks from ``generator``);
    a model built with ``compute_dtype=torch.bfloat16`` computes with
    bfloat16 copies of its float32 master weights.  The guard, the EMA and
    ``state.step`` behave as in ``make_matpes_train_step``.
    """
    return _train_step(state, qm9_loss_grad(state, loss_kind, generator), ema_decay)


def oc20_loss(energy_pred: torch.Tensor, energy_tgt: torch.Tensor, force_pred: torch.Tensor,
              force_tgt: torch.Tensor, node_mask: torch.Tensor, w_energy: float = 2.0,
              w_force: float = 100.0):
    """E-MSE x w_energy + F-L1 x w_force, the force L1 a mean over real
    atoms' components (reference train_oc20v2)."""
    e = torch.mean((energy_pred.float() - energy_tgt) ** 2)
    m = node_mask[:, None].to(torch.float32)
    f = torch.sum(torch.abs(force_pred.float() - force_tgt) * m) / torch.clamp(
        3.0 * node_mask.sum(), min=1.0)
    return w_energy * e + w_force * f, {"energy_mse": e, "force_l1": f}


def oc20_loss_grad(state: TrainState, w_energy: float = 2.0, w_force: float = 100.0,
                   generator: torch.Generator | None = None):
    """``loss_grad(batch) -> (loss, metrics)``, the gradient half of the OC20
    step (see ``make_oc20_train_step``)."""
    model = state.model

    def loss_grad(batch: dict):
        model.train()
        with full_f32_products():
            model.zero_grad(set_to_none=True)
            outs = _forward(model, batch, generator)
            loss, metrics = oc20_loss(outs["energy"], batch["energy"], outs["forces"],
                                      batch["forces"], batch["node_mask"], w_energy, w_force)
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return loss_grad


def make_oc20_train_step(state: TrainState, w_energy: float = 2.0, w_force: float = 100.0,
                         ema_decay: float = 0.999, generator: torch.Generator | None = None):
    """``step(batch) -> (loss, metrics)`` for ``models/oc20.py:EquiformerV2OC20``,
    updating ``state`` in place (the JAX package's ``make_oc20_train_step``).

    The model runs in ``train()`` mode (dropout masks from ``generator``);
    a model built with ``compute_dtype=torch.bfloat16`` computes with
    bfloat16 copies of its float32 master weights.  The guard, the EMA and
    ``state.step`` behave as in ``make_matpes_train_step``.
    """
    return _train_step(state, oc20_loss_grad(state, w_energy, w_force, generator), ema_decay)
