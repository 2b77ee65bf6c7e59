"""Device meshes, batch splits and tensor-parallel convolutions — the
counterpart of ``roadvision_tpu/parallel/sharding.py``.

JAX lays a (data, model) ``Mesh`` over its devices and lets XLA insert
the collectives that ``NamedSharding``s imply. Here a :class:`Mesh` is
the same grid of ``torch.device``s, and what XLA inserts is written out:

  * **data parallelism**: :func:`batch_sharding` splits a batch's
    leading axis over the data groups; ``parallel/data.py`` runs one
    replica of the model per group and sums the gradients;
  * **tensor parallelism**: :func:`param_shardings` is JAX's per-leaf
    rule on the JAX-layout tree, and :func:`shard_model` swaps every conv
    whose kernel the rule splits for a :class:`ColumnParallelConv`: its
    out channels in one shard per model-axis device, the input copied to
    each shard, the outputs concatenated on the group's first device.
    Splitting O leaves every output element's reduction as it was.

A device list may repeat a device (``["cpu"] * 8``, ``[cuda:0] * 4``):
the tests' and one card's stand-in for JAX's virtual CPU devices.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models.yolo import weights as yolo_weights
from ..models.yolo.yolov8 import Conv
from ..utils.device import DeviceLike, resolve_device, visible_devices


class Mesh:
    """A (data, model) grid of devices: ``grid[d][m]`` is model shard m
    of data group d; ``shape`` is ``{"data": …, "model": …}`` as JAX's
    ``mesh.shape``."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [list(row) for row in grid]
        self.shape = {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def devices(self) -> List[torch.device]:
        return [d for row in self.grid for d in row]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: DeviceLike = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (repeats allowed), or over
    :func:`visible_devices` (``n_devices`` cards, or entries of the CPU
    with ``device="cpu"``); the first ``n_devices`` of ``devices`` when
    both are given."""
    if devices is None:
        devs = visible_devices(n_devices, device)
    else:
        devs = [resolve_device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} devices asked for, "
                                 f"{len(devs)} given")
            devs = devs[:n_devices]
    n = len(devs)
    mp = max(1, model_parallel)
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    return Mesh([devs[i:i + mp] for i in range(0, n, mp)])


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """The leading (batch) axis split evenly over the data groups, each
    piece on its group's first device."""
    dp = mesh.shape["data"]
    if x.shape[0] % dp != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by the "
                         f"{dp} data groups")
    return [piece.to(row[0], non_blocking=True)
            for piece, row in zip(x.chunk(dp), mesh.grid)]


def replicated(mesh: Mesh, x):
    """A tensor or module whole on every device of the mesh: one copy per
    distinct device (a module is deep-copied), listed per mesh entry."""
    copies: Dict[torch.device, Any] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev) if torch.is_tensor(x) \
                else copy.deepcopy(x).to(dev)
    return [copies[d] for d in mesh.devices]


def _splits(shape, mp: int, min_channels: int) -> bool:
    """JAX's rule for one leaf (sharding.py:51-75): a 4-D HWIO kernel's O
    or a 1-D leaf goes over ``model`` when it divides and is wide."""
    return len(shape) in (1, 4) and mp > 1 and shape[-1] % mp == 0 \
        and shape[-1] >= min_channels


def param_shardings(params, mesh: Mesh, axis: str = "model",
                    min_channels: int = 64):
    """JAX's tensor-parallel rule on a JAX-layout tree: each leaf's
    partition spec, a tuple of axis names per dimension as
    ``PartitionSpec`` lists them — ``(None, None, None, "model")`` for a
    split conv kernel, ``("model",)`` for a split 1-D leaf, ``()`` for a
    replicated one."""
    mp = mesh.shape[axis]

    def rule(leaf):
        shape = np.shape(leaf)
        if _splits(shape, mp, min_channels):
            return (None,) * (len(shape) - 1) + (axis,)
        return ()

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return rule(tree)

    return walk(params)


class ColumnParallelConv(nn.Module):
    """A ``Conv`` with its out channels in ``len(devices)`` shards, shard
    k on ``devices[k]``: the input goes to every shard (its channel slice
    for a grouped conv), each computes its channels, and the outputs are
    concatenated on ``devices[0]``. Autograd carries the backward through
    the copies. Each shard is the conv's own class, so activation and
    dtype handling are the conv's."""

    def __init__(self, conv: Conv, devices: Sequence[torch.device]):
        super().__init__()
        mp = len(devices)
        o = conv.weight.shape[0]
        if o % mp:
            raise ValueError(f"{o} channels do not split {mp} ways")
        self.devices = list(devices)
        self.shards = nn.ModuleList()
        for k, dev in enumerate(self.devices):
            shard = copy.deepcopy(conv)
            sl = slice(k * o // mp, (k + 1) * o // mp)
            shard.weight = nn.Parameter(conv.weight.detach()[sl].clone())
            shard.bias = nn.Parameter(conv.bias.detach()[sl].clone())
            self.shards.append(shard.to(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mp = len(self.shards)
        grouped = x.shape[1] != self.shards[0].weight.shape[1]
        pieces = x.chunk(mp, dim=1) if grouped else [x] * mp
        outs = [shard(p.to(dev, non_blocking=True))
                for shard, p, dev in zip(self.shards, pieces, self.devices)]
        return torch.cat([o.to(self.devices[0], non_blocking=True)
                          for o in outs], dim=1)


def _tree_key(model: nn.Module, name: str) -> str:
    """A conv module's name → its kernel's key in the flattened JAX tree
    (YOLO state dicts carry a ``layers.`` prefix the tree has not)."""
    if isinstance(getattr(model, "layers", None), nn.ModuleDict):
        name = name[len("layers."):]
    return f"{name}.w"


def shard_model(model: nn.Module, mesh: Mesh, group: int = 0,
                min_channels: int = 64) -> nn.Module:
    """The counterpart of ``shard_pytree(params, param_shardings(…))``: a
    copy of ``model`` on data group ``group`` of the mesh, every conv
    whose kernel :func:`param_shardings` splits (read on the model's
    JAX-layout tree) swapped for a :class:`ColumnParallelConv` over the
    group's model-axis devices, everything else on the group's first
    device. Parameter names gain ``shards.<k>``; :func:`merge_shards`
    undoes that. The other leaves the rule splits (linear and layer-norm
    biases) stay whole: splitting them alone changes no computation."""
    row = mesh.grid[group]
    tree = yolo_weights.flatten_tree(yolo_weights.tree_from_model(model))
    out = copy.deepcopy(model).to(row[0])
    if len(row) == 1:
        return out
    for name, mod in list(out.named_modules()):
        if isinstance(mod, Conv) and _splits(
                tree[_tree_key(out, name)].shape, len(row), min_channels):
            parent, _, child = name.rpartition(".")
            holder = out.get_submodule(parent) if parent else out
            setattr(holder, child, ColumnParallelConv(mod, row))
    return out


_SHARD = re.compile(r"^(.*)\.shards\.(\d+)\.([^.]+)$")


def merge_shards(named: Mapping[str, torch.Tensor],
                 device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """Tensors keyed by a sharded model's parameter names (its state
    dict, gradients, an optimiser's moments) → keyed by the unsharded
    model's, each shard set concatenated along dim 0 on ``device``."""
    out: Dict[str, torch.Tensor] = {}
    pieces: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        m = _SHARD.match(name)
        if m is None:
            out[name] = t.detach().to(device)
        else:
            pieces.setdefault(f"{m.group(1)}.{m.group(3)}", {})[
                int(m.group(2))] = t.detach().to(device)
    for name, parts in pieces.items():
        out[name] = torch.cat([parts[k] for k in sorted(parts)])
    return out
