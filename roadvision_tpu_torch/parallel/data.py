"""The data × tensor-parallel train step — what JAX gets from XLA's SPMD
lowering of ``make_train_step`` under ``param_shardings`` and
``batch_sharding`` (tools/train.py ``--dp``, the dry run).

One replica of the model per data group of a :class:`~.sharding.Mesh`
(its convs column-parallel over the group's model-axis devices when the
mesh has a model axis), the batch split evenly over the groups. A step:

  1. every replica runs its forward and its objective's parts
     (``models/yolo/train.py::Objective``): the loss terms' sums and the
     shares of the batch-global normalisers (target score sums, positive
     and foreground counts, objectness cells, the batch size, gt counts);
  2. the shares are summed on the first device and copied back, so each
     replica divides its sums by the whole batch's normalisers, as XLA
     does: the replicas' losses add up to the single-device loss;
  3. each replica's backward; the gradients are summed onto replica 0 in
     replica order;
  4. the family's guard sees the global loss and gradient norm, its
     optimiser updates replica 0 once, and replica 0's parameters are
     copied to every other replica, which therefore stay identical.

No step reads a value back to the host (RT-DETR's matching aside), and
the copies between devices are asynchronous. The replicas are enqueued
in turn from the calling thread: one host thread enqueues a v8n step
about as fast as one card runs it, so the cards take turns (PERF.md's
multi-card findings; a thread per replica was slower still, the
threads contending for the interpreter).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..models.yolo.train import (Objective, TrainStep, by_device, detached,
                                 global_norm, param_grads, timed)
from .sharding import Mesh, batch_sharding, shard_model


def _total(values, device: torch.device):
    """Replica shares added in replica order on ``device`` (Python
    numbers stay numbers)."""
    out = values[0].to(device) if torch.is_tensor(values[0]) else values[0]
    for v in values[1:]:
        out = out + (v.to(device, non_blocking=True) if torch.is_tensor(v)
                     else v)
    return out


def _on(counts: Dict, device: torch.device) -> Dict:
    return {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in counts.items()}


class DataParallelStep:
    """``step(images, *gts, lr_scale=1.0) → (loss, aux)`` over the mesh's
    data groups with a family's :class:`~..models.yolo.train.TrainStep`.

    ``model`` is replica 0 when the mesh has no model axis (moved to the
    mesh's first device in place, so a caller keeps reading and saving
    it); otherwise replica 0 is :func:`~.sharding.shard_model`'s copy.
    ``state`` is the optimiser state of replica 0 (the step's ``init``
    when None), keyed by its parameter names. ``aux`` holds the global
    components, ``num_fg``, the gradient norm and ``ok``."""

    def __init__(self, step: TrainStep, model: nn.Module, mesh: Mesh,
                 state: Optional[Dict] = None):
        if not isinstance(step.loss_fn, Objective):
            raise TypeError("the data-parallel step needs an Objective loss "
                            "(its batch-global normalisers)")
        self.step, self.mesh = step, mesh
        self.home = mesh.grid[0][0]
        if mesh.shape["model"] > 1:
            self.replicas = [shard_model(model, mesh, g)
                             for g in range(mesh.shape["data"])]
        else:
            self.replicas = [model.to(self.home)] + [
                copy.deepcopy(model).to(row[0]) for row in mesh.grid[1:]]
        self.state = step.init(self.replicas[0]) if state is None else state
        self.names = [n for n, p in self.replicas[0].named_parameters()
                      if p.requires_grad]
        self.params = [[p for p in r.parameters() if p.requires_grad]
                       for r in self.replicas]

    @property
    def model(self) -> nn.Module:
        """Replica 0."""
        return self.replicas[0]

    def __call__(self, *batch, lr_scale: float = 1.0):
        obj = self.step.loss_fn
        pieces = [batch_sharding(self.mesh, t) for t in batch]
        with timed("forward_loss"):
            parts = [obj.parts(rep, *(p[g] for p in pieces))
                     for g, rep in enumerate(self.replicas)]
            counts = {k: _total([c[k] for _, c, _ in parts], self.home)
                      for k in parts[0][1]}
        losses: List[torch.Tensor] = []
        components: List[Dict] = []
        grads = []
        with timed("backward"):
            for rep, row, (sums, _, _) in zip(self.replicas, self.mesh.grid,
                                              parts):
                loss, comp = obj.total(sums, _on(counts, row[0]), rep.nc)
                _, _, g = param_grads(rep, loss)
                losses.append(loss.detach())
                components.append(comp)
                grads.append(g)
            summed = grads[0]
            for g in grads[1:]:
                summed = [a + b.to(a.device, non_blocking=True)
                          for a, b in zip(summed, g)]
            loss = _total(losses, self.home)
            gnorm = global_norm(summed, self.home)
        with timed("optimizer"), torch.no_grad():
            ok, scale = self.step.guard(loss, gnorm)
            params = self.params[0]
            for dev, idx in by_device(params).items():
                self.step.apply([self.names[i] for i in idx],
                                [params[i] for i in idx],
                                [summed[i] for i in idx], self.state,
                                ok.to(dev, non_blocking=True),
                                scale.to(dev, non_blocking=True), lr_scale)
            self.step.finish(self.state, ok)
            for others in self.params[1:]:
                for q, p in zip(others, params):
                    q.copy_(p, non_blocking=True)
        aux = {k: _total([c[k] for c in components], self.home)
               for k in components[0]}
        aux.update({k: _total([a[k] for _, _, a in parts], self.home)
                    for k in parts[0][2]})
        return loss, detached(aux, grad_norm=gnorm, ok=ok)
