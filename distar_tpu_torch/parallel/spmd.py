"""The learner's step on a mesh: batch rows, gradient reduction and the
sharded optimizer state.

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
  batch extent (``all_reduce_sum``).
* **tp and sp.** Ranks that differ only in tp or sp take the same rows and
  run the same forward (sp splits attention inside ``Attention(impl=
  'ring')``); their gradients agree without a reduction. Where each rank's
  loader pulls its own rows (a remote feed), only the block's first rank
  pulls and ``ReplicaFeed`` sends its batch to the others.
* **State.** ``ShardPlan`` places every parameter by the JAX rule
  (``mesh.placement`` on its flax path and shape, mapped to the torch dim
  through the Dense/Conv transposes): the Adam moments live only as this
  rank's block, the update is computed on that block, and the parameters
  are all-gathered over tp and then fsdp after it, so the forward and
  backward read whole tensors (no DTensor ever reaches a kernel).

On a world of one every collective here is skipped.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import placement


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _all_gather(x: torch.Tensor, group, n: int) -> List[torch.Tensor]:
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


class ShardPlan:
    """Where each parameter of ``params`` (the optimizer's list) lives on
    ``mesh``: the JAX learner's spec on the flax leaf, the torch dim each
    split axis lands on, and this rank's block."""

    def __init__(self, model: torch.nn.Module, params: Sequence[torch.Tensor], mesh):
        from ..model.convert import flax_layout

        self.mesh = mesh
        by_id = {id(p): n for n, p in model.named_parameters()}
        sizes = dict(mesh.shape)
        self.dims: List[Dict[str, int]] = []  # axis -> torch dim, per parameter
        self.specs: List[tuple] = []
        for p in params:
            path, perm = flax_layout(model, by_id[id(p)])
            perm = perm or tuple(range(p.dim()))
            flax_shape = tuple(p.shape[d] for d in perm)
            spec = placement(sizes, ("params",) + tuple(path), flax_shape)
            self.specs.append(spec)
            self.dims.append({a: perm[d] for d, a in enumerate(spec) if a})
        self.sharded = any(self.dims)

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of parameter ``i``'s full tensor ``t`` (a view)."""
        for axis, d in self.dims[i].items():
            n = self.mesh.shape[axis]
            step = t.shape[d] // n
            t = t.narrow(d, self.mesh.coords[axis] * step, step)
        return t

    @torch.no_grad()
    def gather_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Fill every full tensor from the blocks the ranks hold: over tp,
        then over fsdp (each rank's own block is already in place), in one
        flat all-gather per stage and dtype."""
        for axis in ("tp", "fsdp"):
            n, group = self.mesh.shape[axis], self.mesh.group(axis)
            if group is None:
                continue
            spans: Dict[torch.dtype, list] = {}
            for i, t in enumerate(tensors):
                dims = self.dims[i]
                if axis not in dims:
                    continue
                # the span this stage gathers: whole along tp once tp is done
                span = t
                if axis == "tp" and "fsdp" in dims:
                    fd, fn = dims["fsdp"], self.mesh.shape["fsdp"]
                    step = t.shape[fd] // fn
                    span = t.narrow(fd, self.mesh.coords["fsdp"] * step, step)
                d = dims[axis]
                step = span.shape[d] // n
                mine = span.narrow(d, self.mesh.coords[axis] * step, step)
                spans.setdefault(t.dtype, []).append((span, d, step, mine))
            for dtype in sorted(spans, key=str):
                items = spans[dtype]
                flat = torch.cat([mine.reshape(-1) for *_, mine in items])
                for j, part in enumerate(_all_gather(flat, group, n)):
                    offset = 0
                    for span, d, step, mine in items:
                        k = mine.numel()
                        span.narrow(d, j * step, step).copy_(part[offset:offset + k].view(mine.shape))
                        offset += k

    def full(self, locals_: Sequence[torch.Tensor], like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Full tensors shaped as ``like`` from this rank's blocks."""
        out = []
        for i, (block, ref) in enumerate(zip(locals_, like)):
            t = torch.zeros_like(ref)
            self.local(i, t).copy_(block)
            out.append(t)
        self.gather_(out)
        return out


def make_plan(model, params, mesh) -> Optional[ShardPlan]:
    """The plan where the mesh splits any parameter (fsdp or tp above 1)."""
    if mesh is None or (mesh.shape["fsdp"] == 1 and mesh.shape["tp"] == 1):
        return None
    plan = ShardPlan(model, params, mesh)
    return plan if plan.sharded else None
