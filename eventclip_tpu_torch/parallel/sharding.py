"""The ('data', 'model') layout of the ranks: Megatron tensor parallelism
and ZeRO-1, decided leaf by leaf on the JAX package's paths and shapes.

Port of eventclip_tpu/parallel/sharding.py. The rules are the JAX
package's, as plain functions of a leaf's '/'-joined tree path and its
JAX shape (the port keeps its own copy):

- model axis (`_leaf_pspec`): inside every `blocks` path the fused qkv
  projection and the MLP's up-projection (`wqkv`, `bqkv`, `w1`, `b1`)
  shard their OUTPUT dim, the attention's out-projection and the MLP's
  down-projection (`wo`, `w2`) their INPUT dim, each only where the dim
  divides by n_model; LoRA factors and everything else stay replicated;
- data axis (`_zero1_extend`, ZeRO-1): each optimizer moment takes the
  data axis on its largest still-unsharded dim that divides by n_data
  (the first of equal ones); scalars stay replicated.

A spec is a tuple with one entry a dim of the JAX leaf (stacked layers
included): None, DATA_AXIS or MODEL_AXIS. The port holds a tower's block
leaves one layer a tensor, and the fused in-projection `wqkv` [L, 3, D, D]
as [3D, D] a layer (models/clip/convert.py); `piece` maps a split of the
JAX leaf onto the port's tensor. The model shard r of `wqkv` is the rows
t·D + r·D/n ... t·D + (r+1)·D/n for each of q, k and v, concatenated in
that order, so the attention kernel sees [q_r | k_r | v_r] with heads / n
heads; `w1` / `b1` take a contiguous row chunk and `wo` / `w2` a column
chunk.

The "mesh" is the layout of the ranks: rank = data_index · n_model +
model_index (make_mesh's device grid, the model axis fastest).
`make_mesh` makes the data groups and the model groups
(torch.distributed.new_group, every rank calling it in the same order)
into a TPContext, which the step, the towers and parallel/distributed.py's
`host_shard_info`, data-parallel mean and model-group sum take as their
`tp` (the context when n_model > 1, else None). `shard_params` cuts each
leaf of a module once, at set-up, and records the context on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.clip.convert import jax_path, jax_shapes

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]

# Megatron layout: fused qkv + mlp-up shard the OUTPUT dim; attn-out +
# mlp-down shard the INPUT dim (weights are torch [out, in]); wqkv is
# [L, 3, D_out, D_in] in the JAX tree, so each shard holds whole heads
_COL_SHARDED = ("wqkv", "b1", "w1", "bqkv")  # out-dim
_ROW_SHARDED = ("wo", "w2")  # in-dim ([..., out, in])


def _leaf_pspec(path: str, shape: Sequence[int], n_model: int) -> Spec:
    """The model-axis spec of one JAX leaf (the JAX package's rule)."""
    ndim = len(shape)
    name = path.split("/")[-1]
    dims: List[Optional[str]] = [None] * ndim
    if n_model > 1 and "blocks" in path:
        if name in _COL_SHARDED:
            # biases ([L, out] / [L, 3, out]) shard dim -1; weights
            # ([L, out, in] / [L, 3, out, in]) shard dim -2
            d = -1 if name.startswith("b") else -2
            if shape[d] % n_model == 0:
                dims[d] = MODEL_AXIS
                return tuple(dims)
        if name in _ROW_SHARDED and ndim >= 2:
            if shape[-1] % n_model == 0:
                dims[-1] = MODEL_AXIS
                return tuple(dims)
    # LoRA deltas and everything else: replicated
    return tuple(dims)


def param_pspecs(shapes: Dict[str, Sequence[int]], n_model: int = 1
                 ) -> Dict[str, Spec]:
    """{JAX path: JAX leaf shape} -> {JAX path: model-axis spec}."""
    return {p: _leaf_pspec(p, s, n_model) for p, s in shapes.items()}


def _zero1_extend(spec: Spec, shape: Sequence[int], n_data: int) -> Spec:
    """The data axis on the largest still-unsharded dim that divides by
    n_data (the first of equal ones); unchanged when none does."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best = None
    for i, (ax, size) in enumerate(zip(dims, shape)):
        if ax is None and size >= n_data and size % n_data == 0:
            if best is None or size > shape[best]:
                best = i
    if best is not None:
        dims[best] = DATA_AXIS
    return tuple(dims)


def zero1_pspecs(shapes: Dict[str, Sequence[int]], n_data: int,
                 n_model: int = 1) -> Dict[str, Spec]:
    """{JAX path: shape} -> the ZeRO-1 spec of each moment leaf: its
    Megatron spec with the data axis added; scalars replicated."""
    out = {}
    for p, s in shapes.items():
        s = tuple(s)
        out[p] = (() if not s else
                  _zero1_extend(_leaf_pspec(p, s, n_model), s, n_data))
    return out


# ---------------------------------------------------------------------------
# a JAX split on the port's tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one port tensor sits in its JAX leaf: the leaf's path, its
    full JAX shape, the layer this tensor holds (None when the leaf is
    not unstacked), whether it is a tower's fused in-projection ([3D(, D)]
    in the port, [3, D(, D)] in JAX), and the leaf's spec."""

    path: str
    shape: Tuple[int, ...]
    layer: Optional[int]
    fused: bool
    spec: Spec

    def axis_dim(self, axis: str) -> Optional[int]:
        """The JAX dim that `axis` takes, or None."""
        return self.spec.index(axis) if axis in self.spec else None


def _fused(path: str) -> bool:
    return (path.startswith(("clip/", "visual/", "text/"))
            and path.endswith(("/wqkv", "/bqkv")))


def placements(named: Iterable[Tuple[str, torch.Tensor]], n_model: int = 1,
               n_data: int = 1, zero1: bool = False
               ) -> Dict[str, Placement]:
    """{port name: Placement} for FULL (unsharded) tensors: the Megatron
    spec, with the ZeRO-1 data axis when `zero1`."""
    named = list(named)
    shapes = jax_shapes(named)
    specs = (zero1_pspecs(shapes, n_data, n_model) if zero1
             else param_pspecs(shapes, n_model))
    out = {}
    for name, _ in named:
        path, layer = jax_path(name)
        out[name] = Placement(path, tuple(shapes[path]), layer,
                              _fused(path), specs[path])
    return out


def _jax_view(t: torch.Tensor, pl: Placement) -> torch.Tensor:
    """The port tensor in its JAX per-layer layout (a view)."""
    if pl.fused:
        return t.reshape((3, t.shape[0] // 3) + tuple(t.shape[1:]))
    return t


def piece(t: torch.Tensor, pl: Placement, axis: str, index: int,
          n: int) -> torch.Tensor:
    """A view of `t` (the port tensor, whole or already cut on another
    axis) holding chunk `index` of `n` of the dim that `axis` takes, in
    the JAX per-layer layout ([3, D/n, D] for a fused wqkv). A tensor that
    holds one layer of a leaf split on its layer dim is whole in the chunk
    that holds the layer and empty in every other."""
    v = _jax_view(t, pl)
    dim = pl.axis_dim(axis)
    if dim is None or n == 1:
        return v
    if pl.layer is not None:
        if dim == 0:
            per = pl.shape[0] // n
            return v if pl.layer // per == index else v[:0]
        dim -= 1
    size = v.shape[dim] // n
    return v.narrow(dim, index * size, size)


def port_layout(v: torch.Tensor, pl: Placement) -> torch.Tensor:
    """A JAX-layout piece back in the port's layout (contiguous)."""
    if pl.fused:
        v = v.reshape((-1,) + tuple(v.shape[2:]))
    return v.contiguous()


# ---------------------------------------------------------------------------
# the layout of the ranks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPContext:
    """This rank's place in the ('data', 'model') layout and its two
    groups: the ranks of its data group share its model index and split
    the batch; the ranks of its model group share its data index and
    split the tower's weights. None where the code takes one means no
    tensor parallelism."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None


def make_mesh(n_model: int = 1) -> TPContext:
    """The layout of the ranks of the process group (one rank without
    one): n_data = world / n_model, rank = data_index · n_model +
    model_index. Makes the groups (a collective: every rank calls it).
    The towers and the data-parallel helpers take the context as their
    `tp` only when n_model > 1. A world that n_model does not divide is
    refused with the JAX package's check."""
    from . import distributed as D

    world = dist.get_world_size() if D.is_distributed() else 1
    rank = dist.get_rank() if D.is_distributed() else 0
    n_model = int(n_model)
    if n_model < 1 or world % n_model:
        raise AssertionError(
            f"{world} devices do not split into a model axis of {n_model} "
            f"(assert n_devices % n_model == 0: ({world}, {n_model}))")
    n_data = world // n_model
    data_group = model_group = None
    if D.is_distributed() and n_model > 1:
        # every rank makes every group, in one order
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
    return TPContext(n_data=n_data, n_model=n_model,
                     data_index=rank // n_model, model_index=rank % n_model,
                     data_group=data_group, model_group=model_group)


@torch.no_grad()
def shard_params(model: nn.Module, tp: Optional[TPContext]) -> None:
    """Cut every leaf of `model` (a ClassifierParams) to this rank's model
    shard, in place and once: each sharded parameter's data becomes its
    contiguous chunk (the optimizer, built after, sees the local tensors).
    Records `model.tp` and `model.placements` ({port name: Placement of
    the full leaf}), which the step, the optimizer and the checkpoints
    read. Without a context only the records are set."""
    named = list(model.named_parameters())
    n_model = tp.n_model if tp is not None else 1
    pls = placements(named, n_model=n_model)
    if tp is not None:
        for name, p in named:
            pl = pls[name]
            if pl.axis_dim(MODEL_AXIS) is not None:
                p.data = port_layout(piece(p.data, pl, MODEL_AXIS,
                                           tp.model_index, n_model), pl)
    model.tp = tp
    model.placements = pls


def model_placements(model: nn.Module) -> Dict[str, Placement]:
    """`model.placements` when `shard_params` set them, else those of the
    model's (whole) tensors with no model axis."""
    pls = getattr(model, "placements", None)
    return pls if pls is not None else placements(model.named_parameters())


def zero1_placement(pl: Placement, n_data: int) -> Placement:
    """The moment's placement: `pl` with the ZeRO-1 data axis added (on
    the full JAX shape)."""
    if not pl.shape:
        return pl
    return dataclasses.replace(pl, spec=_zero1_extend(pl.spec, pl.shape,
                                                      n_data))


def shard_opt_state(state: Dict[str, torch.Tensor],
                    pls: Dict[str, Placement], tp: Optional[TPContext],
                    n_data: int, data_index: int, zero1: bool
                    ) -> Dict[str, torch.Tensor]:
    """{port name: full moment} -> this rank's part of each: its model
    shard, and with `zero1` its data slice (in the port's layout)."""
    out = {}
    for name, full in state.items():
        pl = pls[name]
        t = full
        if tp is not None:
            t = port_layout(piece(t, pl, MODEL_AXIS, tp.model_index,
                                  tp.n_model), pl)
        if zero1:
            t = piece(t, zero1_placement(pl, n_data), DATA_AXIS, data_index,
                      n_data).contiguous()
        out[name] = t
    return out


GATHER_BUCKET_BYTES = 64 << 20


def gather_pieces(targets: Sequence[torch.Tensor],
                  pls: Sequence[Placement], mine: Sequence[torch.Tensor],
                  axis: str, index: int, n: int, group) -> None:
    """All-gather: every rank of `group` (n ranks, this one `index`)
    contributes `mine[i]`, its piece of `targets[i]` on `axis`, and every
    rank's pieces are copied into their places in `targets` (in place).
    The targets go in buckets of at most GATHER_BUCKET_BYTES a rank (a
    larger piece alone), one flat buffer a rank and bucket, padded to the
    largest rank's, so pieces of unequal size (a leaf split on its layer
    dim) gather too; the buffers live one bucket at a time."""
    sizes = [[piece(t, pl, axis, d, n).numel() for d in range(n)]
             for t, pl in zip(targets, pls)]
    cap = GATHER_BUCKET_BYTES // max(targets[0].element_size(), 1) \
        if targets else 0
    start = 0
    while start < len(targets):
        held, stop = list(sizes[start]), start + 1
        while stop < len(targets):
            grown = [h + k for h, k in zip(held, sizes[stop])]
            if max(grown) > cap:
                break
            held, stop = grown, stop + 1
        _gather_bucket(targets[start:stop], pls[start:stop],
                       mine[start:stop], axis, n, group, max(held))
        start = stop


def _gather_bucket(targets, pls, mine, axis, n, group, width) -> None:
    from . import distributed as D

    if not width:
        return
    ref = targets[0]
    flat = torch.zeros(width, dtype=ref.dtype, device=ref.device)
    off = 0
    for m in mine:
        flat[off:off + m.numel()].view(m.shape).copy_(m)
        off += m.numel()
    bufs = D.all_gather(flat, group)
    for d in range(n):
        off = 0
        for t, pl in zip(targets, pls):
            v = piece(t, pl, axis, d, n)
            k = v.numel()
            if k:
                v.copy_(bufs[d][off:off + k].view(v.shape))
            off += k


@torch.no_grad()
def full_tensors(named: Sequence[Tuple[str, torch.Tensor]],
                 pls: Dict[str, Placement], tp: Optional[TPContext]
                 ) -> List[Tuple[str, torch.Tensor]]:
    """(name, local tensor) pairs -> (name, whole tensor): the model shards
    gathered over the model group (a collective for every rank of it);
    replicated tensors pass as they are. Without a context: unchanged."""
    if tp is None:
        return list(named)
    split = [(n, t) for n, t in named
             if pls[n].axis_dim(MODEL_AXIS) is not None]
    if not split:
        return list(named)
    whole = {}
    targets = []
    for n, t in split:
        pl = pls[n]
        shape = list(t.shape)
        dim = pl.axis_dim(MODEL_AXIS) - (pl.layer is not None)
        if pl.fused:  # the port dim 0 is 3 x the JAX dim 1
            shape[0] *= tp.n_model
        else:
            shape[dim] *= tp.n_model
        whole[n] = torch.empty(shape, dtype=t.dtype, device=t.device)
        targets.append(whole[n])
    gather_pieces(targets, [pls[n] for n, _ in split],
                  [t for _, t in split], MODEL_AXIS, tp.model_index,
                  tp.n_model, tp.model_group)
    return [(n, whole.get(n, t)) for n, t in named]


class _GatherModel(torch.autograd.Function):
    """A model shard -> the whole leaf (all-gathered over the model
    group); backward keeps this rank's piece of the whole gradient, which
    every model rank holds alike (the consumer's inputs are replicated)."""

    @staticmethod
    def forward(ctx, local, pl, tp):
        ctx.pl, ctx.tp = pl, tp
        return full_tensors([("leaf", local)], {"leaf": pl}, tp)[0][1]

    @staticmethod
    def backward(ctx, g):
        pl, tp = ctx.pl, ctx.tp
        return (port_layout(piece(g, pl, MODEL_AXIS, tp.model_index,
                                  tp.n_model), pl), None, None)


def gather_model(named: Iterable[Tuple[str, torch.Tensor]], prefix: str,
                 pls: Dict[str, Placement], tp: TPContext
                 ) -> Dict[str, torch.Tensor]:
    """{name: whole tensor} for the model-sharded ones of `named` (names
    relative to a module; `prefix` + name is the ClassifierParams name),
    differentiable: for a consumer that runs on whole leaves."""
    out = {}
    for name, t in named:
        pl = pls.get(name if name.startswith(prefix) else prefix + name)
        if pl is not None and pl.axis_dim(MODEL_AXIS) is not None:
            out[name] = _GatherModel.apply(t, pl, tp)
    return out
