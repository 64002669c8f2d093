"""The learner's step on a mesh: batch rows, gradient reduction, and the
parameters held and computed as the JAX learner's shardings place them.

What GSPMD does for the JAX learner from its shardings, the port does by
hand, so that a step on a mesh equals the single-process step on the whole
batch:

* **Rows.** Each rank takes its block of the global batch (the batch
  extent, dp x fsdp, dp-major: ``take_rows``) and runs the model on it.
  The model's outputs and the loss's inputs are gathered back to the whole
  batch (``gather_rows``: an all-gather whose backward hands each rank the
  gradient of its own rows), and every rank computes the loss on the whole
  batch: every global mean, masked mean and info scalar is the JAX
  learner's. The gradients (each rank's rows' share) are summed over the
  batch extent (``reduce_grads``).
* **tp and sp replicas.** Ranks that differ only in tp or sp take the same
  rows; sp splits attention inside ``Attention(impl='ring')``. Where each
  rank's loader pulls its own rows (a remote feed), only the block's first
  rank pulls and ``ReplicaFeed`` sends its batch to the others.
* **Placement** (``shard_model``). Every parameter is placed by the JAX
  rule (``mesh.placement`` on its flax path and shape, mapped to the torch
  dim through the Dense/Conv transposes). A rank holds only its block of
  each, so the gradients, mu and nu are blocks too: nothing whole lives
  between steps.
* **fsdp: ZeRO-3.** Each unit of the model (the scalar, entity and spatial
  encoders, the entity-to-map projection, the core LSTM, each action head,
  the value encoder and each value tower) all-gathers its fsdp blocks in
  one flat collective just before it runs and puts the blocks back after;
  autograd keeps the whole tensors its backward reads until that backward
  ends, and the gather's backward reduce-scatters the unit's gradients into
  their blocks, which ``reduce_grads`` then sums over dp.
* **tp: Megatron.** A Linear, Conv2d or Embedding whose weight tp splits
  runs on the rank's block with one collective (``TPLinear``,
  ``TPConv2d``, ``TPEmbedding``): a split output is computed locally and
  its features all-gathered, a split input takes the input's block and
  all-reduces the partial product; a vocabulary split looks up the rows it
  holds and all-reduces. The attention gathers its QKV output (JAX's block
  of the 3 H Dh columns is not aligned to heads), keeps its H/tp heads,
  runs attention on them, and its output projection is row-parallel on
  exactly those heads (``TPAttention``). Every other leaf tp splits
  (biases, LayerNorm scales, the small bare leaves) is gathered whole
  before its unit runs. Activations outside these ops are the same on
  every tp rank, and so are their gradients.
* **Whole state** is gathered only where it is read whole (``whole``: a
  whole checkpoint, ``learner_state_to_flax``, the parameter publish), and
  norms are read from the blocks (``leaf_norms``: the squares of the
  blocks summed over the ranks that split each leaf, one all-reduce).

Kernels still receive plain contiguous tensors: no DTensor reaches one. On
a world of one, or on a mesh that splits no parameter, the placement keeps
every parameter whole: its blocks are the tensors, and every collective is
skipped.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.transformer import Attention
from .mesh import ONE_DEVICE, placement


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _all_gather(x: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    if x.is_meta:  # the flop count's placed copy (shapes only): no collective
        return [x] * n
    src = x.contiguous()
    if src.dtype == torch.bool:  # gloo and NCCL move bytes, not bools
        parts = _all_gather(src.to(torch.uint8), group, n)
        return [p.to(torch.bool) for p in parts]
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, n):
        ctx.dim, ctx.index, ctx.n = dim, index, n
        return torch.cat(_all_gather(x, group, n), dim)

    @staticmethod
    def backward(ctx, grad):
        rows = grad.shape[ctx.dim] // ctx.n
        return grad.narrow(ctx.dim, ctx.index * rows, rows), None, None, None, None


def gather_rows(tree, dim: int, mesh):
    """Every tensor of ``tree`` gathered along ``dim`` over the batch
    extent, in block order; its gradient is this rank's block of the
    incoming one. The tree itself without a batch group."""
    group = mesh.group("batch") if mesh is not None else None
    if group is None:
        return tree
    n, index = mesh.size("batch"), mesh.index("batch")

    def one(x):
        if x.requires_grad:
            return _GatherRows.apply(x, dim, group, index, n)
        return torch.cat(_all_gather(x, group, n), dim)

    return _tree_map(one, tree)


def take_rows(tree, dim: int, mesh, batch: int, local: bool = False):
    """This rank's block (``feeder.assemble_global`` under the batch
    sharding of ``dim``) of every array of ``tree`` whose ``dim`` has the
    global ``batch`` rows, numpy or tensor; other leaves stay whole.
    ``local``: the arrays already are this rank's rows."""
    from .feeder import assemble_global
    from .mesh import batch_sharding

    if mesh is None or mesh.size("batch") == 1:
        return tree
    sharding = batch_sharding(mesh, batch_axis=dim)

    def one(x):
        if not hasattr(x, "shape") or len(x.shape) <= dim or x.shape[dim] != batch:
            return x
        return assemble_global(x, sharding, local=local)

    if isinstance(tree, dict):
        return {k: take_rows(v, dim, mesh, batch, local) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(v, dim, mesh, batch, local) for v in tree)
    return one(tree)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum ``tensors`` in place over ``group`` in one flat all-reduce."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def reduce_info(info: Dict[str, torch.Tensor], prefix: str, mesh) -> None:
    """Sum the info scalars under ``prefix`` (counts over this rank's rows,
    e.g. the batch census) over the batch extent, in place."""
    group = mesh.group("batch") if mesh is not None else None
    keys = sorted(k for k in info if k.startswith(prefix))
    if group is None or not keys:
        return
    vals = torch.stack([info[k].float() for k in keys])
    dist.all_reduce(vals, group=group)
    for k, v in zip(keys, vals.unbind()):
        info[k] = v.to(info[k].dtype)


_END, _FAILED = "end", "failed"


class ReplicaFeed:
    """One batch for the tp x sp replicas of a batch block: the block's
    first rank (``lead``) pulls it from its loader, the others receive it
    (a small pickled skeleton, then one broadcast of its tensors' bytes,
    on the device they lie on). The lead's end or failure ends or
    fails every replica's ``next`` too, so none is left waiting."""

    def __init__(self, mesh, device):
        self.group, self.src = mesh.group("replica"), mesh.replica_lead()
        self.lead = mesh.rank == self.src
        self.device = torch.device(device)

    def next(self, source):
        """The lead's ``next(source)``, on every replica (``source`` is
        read only on the lead)."""
        if self.lead:
            try:
                batch = next(source)
            except StopIteration:
                self._send_skeleton(_END)
                raise
            except BaseException:
                self._send_skeleton(_FAILED)
                raise
            tensors: List[torch.Tensor] = []

            def slot(t):
                tensors.append(t)
                return _Slot(len(tensors) - 1, t.shape, t.dtype)

            self._send_skeleton(_tree_map(slot, batch))
            self._broadcast(tensors)
            return batch
        skeleton = self._send_skeleton(None)
        if skeleton == _END:
            raise StopIteration
        if skeleton == _FAILED:
            raise RuntimeError(f"rank {self.src}, which pulls this block's batches, failed")
        received: Dict[int, torch.Tensor] = {}

        def alloc(s):
            received[s.index] = torch.empty(s.shape, dtype=s.dtype, device=self.device)
            return received[s.index]

        batch = _map_slots(alloc, skeleton)
        self._broadcast([received[i] for i in range(len(received))])
        return batch

    def _send_skeleton(self, skeleton):
        box = [skeleton]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def _broadcast(self, tensors: List[torch.Tensor]) -> None:
        """Every tensor's bytes in one broadcast (gloo takes few dtypes)."""
        if not tensors:
            return
        views = [t.reshape(-1).view(torch.uint8) for t in tensors]
        wire = torch.cat(views) if self.lead else torch.empty(
            sum(v.numel() for v in views), dtype=torch.uint8, device=self.device)
        dist.broadcast(wire, src=self.src, group=self.group)
        if not self.lead:
            offset = 0
            for v in views:
                v.copy_(wire[offset:offset + v.numel()])
                offset += v.numel()


class _Slot:
    def __init__(self, index, shape, dtype):
        self.index, self.shape, self.dtype = index, tuple(shape), dtype


def _map_slots(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_slots(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_slots(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, _Slot) else tree


def replica_feed(mesh, device) -> Optional[ReplicaFeed]:
    """The feed for a per-rank loader where tp x sp replicas share a batch."""
    if mesh is None or mesh.group("replica") is None:
        return None
    return ReplicaFeed(mesh, device)


# ------------------------------------------------------------ placement
class _Axis:
    """One mesh axis that splits a list of tensors: its group and size,
    this rank's index, the torch dim each tensor is split along, and
    whether the gradients arriving at a gather are summed over the axis
    (fsdp: its ranks ran other rows) or equal on every rank (tp).
    ``name`` is the unit's, for the cost tool's timers."""

    def __init__(self, mesh, axis: str, dims: Sequence[int], summed: bool, name: str = ""):
        self.group, self.n, self.index = mesh.group(axis), mesh.shape[axis], mesh.coords[axis]
        self.axis, self.dims, self.summed, self.name = axis, list(dims), summed, name


def _by_dtype(tensors) -> Dict[torch.dtype, List[int]]:
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def gather_blocks(blocks: Sequence[torch.Tensor], axis: _Axis) -> List[torch.Tensor]:
    """Each of ``blocks`` all-gathered along its dim over ``axis``, in
    coordinate order: one flat all-gather per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(blocks)
    for dtype, idx in sorted(_by_dtype(blocks).items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([blocks[i].reshape(-1) for i in idx])
        parts = _all_gather(flat, axis.group, axis.n)
        offset = 0
        for i in idx:
            b, k = blocks[i], blocks[i].numel()
            out[i] = torch.cat([p[offset:offset + k].view(b.shape) for p in parts], axis.dims[i])
            offset += k
    return out


def reduce_scatter_blocks(wholes: Sequence[torch.Tensor], axis: _Axis) -> List[torch.Tensor]:
    """Each of ``wholes`` summed over ``axis`` and cut to this rank's block
    along its dim: one flat reduce-scatter per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(wholes)
    for dtype, idx in sorted(_by_dtype(wholes).items(), key=lambda kv: str(kv[0])):
        steps = [wholes[i].shape[axis.dims[i]] // axis.n for i in idx]
        chunks = [torch.cat([wholes[i].narrow(axis.dims[i], j * s, s).reshape(-1) for i, s in zip(idx, steps)])
                  for j in range(axis.n)]
        mine = torch.empty_like(chunks[0])
        if not mine.is_meta:
            dist.reduce_scatter(mine, chunks, group=axis.group)
        offset = 0
        for i, s in zip(idx, steps):
            shape = list(wholes[i].shape)
            shape[axis.dims[i]] = s
            k = int(torch.Size(shape).numel())
            out[i] = mine[offset:offset + k].view(shape)
            offset += k
    return out


def _block(t: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    step = t.shape[dim] // n
    return t.narrow(dim, index * step, step)


class _GatherBlocks(torch.autograd.Function):
    """Parameter blocks gathered over one axis. The backward sums the
    gradients over the axis into the blocks (a reduce-scatter) where the
    axis's ranks ran other rows, and takes this rank's block of them where
    they ran the same."""

    @staticmethod
    def forward(ctx, axis, *blocks):
        ctx.axis = axis
        return tuple(gather_blocks(blocks, axis))

    @staticmethod
    def backward(ctx, *grads):
        a = ctx.axis
        if a.summed:
            return (None, *reduce_scatter_blocks(grads, a))
        return (None, *(_block(g, d, a.n, a.index) for g, d in zip(grads, a.dims)))


def _tp_all_reduce(x: torch.Tensor, tp: _Axis) -> torch.Tensor:
    """A copy of ``x`` summed over tp (a meta tensor: copied only)."""
    x = x.contiguous().clone()
    if not x.is_meta:
        dist.all_reduce(x, group=tp.group)
    return x


class _TPCopy(torch.autograd.Function):
    """The input of a tp-split product: the same on every tp rank; its
    gradient, each rank's share, is summed over tp."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, grad):
        return _tp_all_reduce(grad, ctx.tp), None


class _TPReduce(torch.autograd.Function):
    """Partial products summed over tp; the gradient is the same on every
    rank already."""

    @staticmethod
    def forward(ctx, x, tp):
        return _tp_all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TPGather(torch.autograd.Function):
    """Each tp rank's block of ``dim`` gathered whole; the gradient is
    this rank's block of the (equal) incoming one."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return torch.cat(_all_gather(x, tp.group, tp.n), dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.dim, ctx.tp.n, ctx.tp.index), None, None


class _TPSplit(torch.autograd.Function):
    """This tp rank's block of ``dim``; the gradient is the ranks' blocks
    gathered whole."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _block(x, dim, tp.n, tp.index).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_all_gather(grad, ctx.tp.group, ctx.tp.n), ctx.dim), None, None


class TPLinear(nn.Linear):
    """A Linear whose weight is this tp rank's block: of the output
    features (dim 0: column-parallel, the features all-gathered) or of the
    input features (dim 1: row-parallel, the partial products
    all-reduced). The bias is whole."""

    tp: _Axis  # over tp, the weight's split dim

    def forward(self, x, split: bool = False):
        """``split``: row-parallel on an input that already is this rank's
        block of the features."""
        if self.tp.dims[0] == 1:
            x = x if split else _TPSplit.apply(x, -1, self.tp)
            y = _TPReduce.apply(F.linear(x, self.weight), self.tp)
        else:
            y = _TPGather.apply(F.linear(_TPCopy.apply(x, self.tp), self.weight), -1, self.tp)
        return y if self.bias is None else y + self.bias


class TPConv2d(nn.Conv2d):
    """A Conv2d whose weight is this tp rank's block of the output
    channels (dim 0: the channels all-gathered) or of the input channels
    (dim 1: the input's block convolved, the partial maps all-reduced).
    The bias is whole."""

    tp: _Axis

    def forward(self, x):
        if self.tp.dims[0] == 0:
            y = _TPGather.apply(self._conv_forward(_TPCopy.apply(x, self.tp), self.weight, None), 1, self.tp)
        else:
            y = _TPReduce.apply(self._conv_forward(_TPSplit.apply(x, 1, self.tp), self.weight, None), self.tp)
        return y if self.bias is None else y + self.bias[:, None, None]


class TPEmbedding(nn.Embedding):
    """An Embedding whose table is this tp rank's block of the features
    (dim 1: looked up, then all-gathered) or of the vocabulary (dim 0: the
    ids it holds looked up, the others zero, all-reduced)."""

    tp: _Axis

    def forward(self, ids):
        if self.tp.dims[0] == 1:
            return _TPGather.apply(F.embedding(ids, self.weight), -1, self.tp)
        rows = self.weight.shape[0]
        local = ids - self.tp.index * rows
        inside = (local >= 0) & (local < rows)
        y = F.embedding(local.clamp(0, rows - 1), self.weight) * inside[..., None].to(self.weight.dtype)
        return _TPReduce.apply(y, self.tp)


class TPAttention(Attention):
    """Attention on this tp rank's H/tp heads: the QKV output whole
    (``Dense_0`` gathers it), this rank's heads of q, k and v, attention at
    [B, H/tp, N, Dh], and the output projection row-parallel on exactly
    those heads."""

    tp: _Axis

    def forward(self, x, mask=None):
        B, N, _ = x.shape
        qkv = self.Dense_0(x).reshape(B, N, 3, self.head_num, self.head_dim)
        q, k, v = (t.contiguous() for t in _TPSplit.apply(qkv, 3, self.tp).permute(2, 0, 3, 1, 4).unbind(0))
        out = self.attend(q, k, v, mask)
        return self.Dense_1(out.transpose(1, 2).reshape(B, N, -1), split=True)


_TP_CLASSES = {nn.Linear: TPLinear, nn.Conv2d: TPConv2d, nn.Embedding: TPEmbedding}


def model_units(model: nn.Module):
    """The units a ZeRO-3 model gathers at a time, as (name, module): the
    children of its encoder and of its policy, and its other children (the
    core LSTM, the value encoder, each value tower)."""
    units = []
    for name, child in model.named_children():
        if name in ("encoder", "policy"):
            units += [(f"{name}.{n}", c) for n, c in child.named_children()]
        else:
            units.append((name, child))
    return units


class _Unit:
    """One unit's split parameters, gathered just before the unit runs
    (over fsdp, then over tp for those read whole) and put back as blocks
    after it."""

    def __init__(self, shards, name, module, items):
        self.shards, self.name = shards, name
        self.items = items  # (owner module, attribute, parameter index, read whole)
        dims = shards.dims
        self.fsdp = [k for k, (_, _, i, _) in enumerate(items) if "fsdp" in dims[i]]
        self.tp = [k for k, (_, _, i, whole) in enumerate(items) if whole and "tp" in dims[i]]
        mesh = shards.mesh
        self.fsdp_axis = _Axis(mesh, "fsdp", [dims[items[k][2]]["fsdp"] for k in self.fsdp], True, name)
        self.tp_axis = _Axis(mesh, "tp", [dims[items[k][2]]["tp"] for k in self.tp], False, name)
        module.register_forward_pre_hook(self.gather)
        module.register_forward_hook(self.release, always_call=True)

    def gather(self, module, args):
        ts = [self.shards.params[i] for _, _, i, _ in self.items]
        for keep, axis in ((self.fsdp, self.fsdp_axis), (self.tp, self.tp_axis)):
            if keep:
                for k, t in zip(keep, _GatherBlocks.apply(axis, *(ts[k] for k in keep))):
                    ts[k] = t
        for (owner, attr, _, _), t in zip(self.items, ts):
            owner._parameters[attr] = t

    def release(self, module, args, output):
        for owner, attr, i, _ in self.items:
            owner._parameters[attr] = self.shards.params[i]


class ParamShards:
    """Every parameter of ``model`` placed on ``mesh`` by the JAX rule: its
    spec on the flax leaf, the torch dim each split axis lands on, and this
    rank's block, which the parameter holds from then on (the model is
    changed in place: its tp-split modules compute on their blocks, its
    units gather their fsdp blocks around their forward). With no mesh
    (one process) every parameter is whole."""

    def __init__(self, model: nn.Module, mesh=None):
        from ..model.convert import flax_layout

        placed = getattr(model, "param_shards", None)
        if placed is not None and placed.splits:
            raise ValueError(f"the model is placed on {placed.mesh} already")
        self.mesh = mesh = ONE_DEVICE if mesh is None else mesh
        sizes = dict(mesh.shape)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.shapes = [tuple(p.shape) for p in self.params]  # whole, torch layout
        self.specs: List[tuple] = []
        self.dims: List[Dict[str, int]] = []  # axis -> torch dim, per parameter
        for name, p in named:
            if mesh is ONE_DEVICE:
                spec, perm = (None,) * p.dim(), None
            else:
                path, perm = flax_layout(model, name)
                perm = perm or tuple(range(p.dim()))
                spec = placement(sizes, ("params",) + tuple(path), tuple(p.shape[d] for d in perm))
            self.specs.append(spec)
            self.dims.append({a: perm[d] for d, a in enumerate(spec) if a})
        self.splits = any(self.dims)  # whether any leaf is split: ``whole`` is then a collective
        coords = mesh.coords
        # counted once over the shard group: the ranks at 0 of every axis that does not split it
        self.counted = [all(coords[a] == 0 for a in ("fsdp", "tp") if a not in d) for d in self.dims]
        with torch.no_grad():
            for i, p in enumerate(self.params):
                if self.dims[i]:
                    p.data = self.local(i, p.data).clone()
        kept = self._split_modules(model)
        self.units = []
        owners = {}
        for mod in model.modules():
            for attr, p in mod.named_parameters(recurse=False):
                owners[id(p)] = (mod, attr)
        covered = set()
        for name, unit in model_units(model):
            items = []
            for pname, p in unit.named_parameters(prefix=name):
                i = self.index[pname]
                covered.add(i)
                if self.dims[i] and not (i in kept and "fsdp" not in self.dims[i]):
                    items.append((*owners[id(p)], i, i not in kept))
            if items:
                self.units.append(_Unit(self, name, unit, items))
        loose = [self.names[i] for i in range(len(self.names)) if self.dims[i] and i not in covered]
        if loose:
            raise ValueError(f"split parameters outside every unit: {loose[:5]}")
        model.param_shards = self

    def _split_modules(self, model):
        """Give each Linear, Conv2d and Embedding whose weight tp splits
        (on an output or input dim) its tp class, and each attention whose
        heads divide tp and whose output projection tp splits by input its
        head split; the weights so kept as tp blocks, by index."""
        kept = set()
        if self.mesh.group("tp") is None:
            return kept
        for name, mod in model.named_modules():
            cls = _TP_CLASSES.get(type(mod))
            i = self.index.get(f"{name}.weight")
            d = self.dims[i].get("tp") if cls is not None and i is not None else None
            if d is None or d > 1 or getattr(mod, "padding_idx", None) is not None:
                continue
            mod.__class__, mod.tp = cls, _Axis(self.mesh, "tp", [d], False, name)
            kept.add(i)
        for name, mod in model.named_modules():
            if type(mod) is Attention and mod.head_num % self.mesh.shape["tp"] == 0 and (
                    isinstance(mod.Dense_1, TPLinear) and mod.Dense_1.tp.dims[0] == 1):
                mod.__class__, mod.tp = TPAttention, _Axis(self.mesh, "tp", [3], False, name)
        return kept

    # --------------------------------------------------------------- blocks
    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of parameter ``i``'s whole tensor ``t`` (a view)."""
        for axis, d in self.dims[i].items():
            t = _block(t, d, self.mesh.shape[axis], self.mesh.coords[axis])
        return t

    def block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` of parameter ``name``."""
        return self.local(self.index[name], t)

    @torch.no_grad()
    def whole(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors from every parameter's blocks (``tensors`` in the
        parameters' order: the parameters, gradients, mu or nu), gathered
        over fsdp, then tp: a collective every rank of the mesh calls."""
        ts = [t.detach() for t in tensors]
        for name in ("fsdp", "tp"):
            idx = [i for i in range(len(ts)) if name in self.dims[i]]
            if idx and self.mesh.group(name) is not None:
                axis = _Axis(self.mesh, name, [self.dims[i][name] for i in idx], False)
                for i, t in zip(idx, gather_blocks([ts[i] for i in idx], axis)):
                    ts[i] = t
        return ts

    def leaf_norms(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of each whole leaf, from its blocks: a split leaf's
        squares summed over the ranks that split it, in one all-reduce over
        the shard group; a whole leaf's norm as it is."""
        norms = torch.stack(torch._foreach_norm(list(tensors)))
        if not self.splits:
            return norms
        split = torch.tensor([bool(d) for d in self.dims], device=norms.device)
        counted = torch.tensor(self.counted, device=norms.device)
        sq = torch.where(split & counted, norms.double().square(), torch.zeros_like(norms, dtype=torch.float64))
        dist.all_reduce(sq, group=self.mesh.group("shard"))
        return torch.where(split, sq.sqrt().to(norms.dtype), norms)

    def collective_bytes(self) -> Dict[str, float]:
        """The step's parameter-side collective traffic a rank sends, in
        bytes: the units' fsdp all-gathers and reduce-scatters (each once:
        the gathered tensors are kept until the unit's backward), the tp
        gathers of the leaves read whole, and the gradients' all-reduces
        over dp (over dp x fsdp for a leaf fsdp does not split). The tp
        activations' collectives depend on the batch and are not counted."""
        s = self.mesh.shape
        fsdp = sum(p.numel() * p.element_size() for p, d in zip(self.params, self.dims) if "fsdp" in d)
        rest = sum(p.numel() * p.element_size() for p, d in zip(self.params, self.dims) if "fsdp" not in d)
        whole_tp = sum(p.numel() * p.element_size() for u in self.units for _, _, i, whole in u.items
                       if whole and "tp" in self.dims[i] for p in (self.params[i],))
        out = {"fsdp_allgather": float((s["fsdp"] - 1) * fsdp),
               "fsdp_reducescatter": float((s["fsdp"] - 1) * fsdp),
               "tp_param_allgather": float((s["tp"] - 1) * whole_tp * s["fsdp"]),
               "grad_allreduce": 2.0 * (s["dp"] - 1) / s["dp"] * fsdp
               + 2.0 * (s["dp"] * s["fsdp"] - 1) / (s["dp"] * s["fsdp"]) * rest}
        return {k: v for k, v in out.items() if v}


def shard_model(model: nn.Module, mesh) -> ParamShards:
    """Place ``model``'s parameters on ``mesh`` (``ParamShards``); with no
    mesh, or one that splits no parameter, every parameter stays whole."""
    return ParamShards(model, mesh)


def param_shards(model: nn.Module) -> ParamShards:
    """The placement ``shard_model`` gave ``model``; a model never placed
    gets the one-process placement (every parameter whole)."""
    placed = getattr(model, "param_shards", None)
    return placed if placed is not None else ParamShards(model)


def reduce_grads(grads: Sequence[torch.Tensor], mesh, shards: ParamShards) -> None:
    """Sum each rank's share of the gradients over the batch extent, in
    place: a leaf fsdp splits (``shards``) was summed over fsdp into its
    block already, so over dp; any other over dp x fsdp."""
    if mesh is None:
        return
    split = [i for i, d in enumerate(shards.dims) if "fsdp" in d]
    all_reduce_sum([grads[i] for i in split], mesh.group("dp"))
    rest = sorted(set(range(len(grads))) - set(split))
    all_reduce_sum([grads[i] for i in rest], mesh.group("batch"))
