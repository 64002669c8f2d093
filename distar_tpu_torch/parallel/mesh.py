"""The learner's device mesh: a (dp, fsdp, tp, sp) grid of process ranks.

Counterpart of ``distar_tpu.parallel.mesh``. A JAX mesh is a grid of the
devices one program sees; here it is a grid of ``torch.distributed`` ranks
(one device each: NCCL on CUDA, gloo on the CPU), laid out row-major over
the four axes, with a ``torch.distributed.device_mesh.DeviceMesh`` of the
same shape and one process group per axis:

* dp   — data: each dp index takes its own rows of the global batch;
* fsdp — parameter shard, and extra data parallelism (``dp_axes``);
* tp   — tensor: parameters and Adam moments placed by the Megatron rule;
* sp   — sequence: ``Attention(impl='ring')`` splits the set axis over it.

Shardings are ``NamedSharding(mesh, spec)``: one entry per array dim, None
or the axis names it splits over, as JAX's ``PartitionSpec``; ``spec_string``
prints it as JAX does, and ``placements`` gives DTensor's placements.
``param_sharding`` is JAX's placement rule, a pure function of the axis
sizes, the flax path and the flax shape of each leaf, so a port learner
places its (transposed) tensors exactly where the JAX learner places the
same leaves, and writes the same sharded checkpoint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

AXES = ("dp", "fsdp", "tp", "sp")


class MeshConfigError(ValueError):
    """A mesh or batch configuration cannot be realised on the available
    ranks (axes don't factor the rank count, or a batch doesn't divide the
    data-parallel extent)."""


# The mesh that model-internal sharded ops (ring attention over sp) use:
# the learner declares it here before it builds its step.
_CONTEXT_MESH = None


def set_context_mesh(mesh) -> None:
    global _CONTEXT_MESH
    _CONTEXT_MESH = mesh


def get_context_mesh():
    return _CONTEXT_MESH


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = -1  # -1: all remaining ranks
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    def sizes(self, n_devices: int) -> Sequence[int]:
        fixed = self.fsdp * self.tp * self.sp
        if fixed <= 0 or (self.dp != -1 and self.dp <= 0):
            raise MeshConfigError(
                f"mesh axes must be positive (got dp={self.dp}, "
                f"fsdp={self.fsdp}, tp={self.tp}, sp={self.sp})"
            )
        dp = self.dp if self.dp != -1 else n_devices // fixed
        if dp * fixed != n_devices:
            raise MeshConfigError(
                f"mesh dp={dp} x fsdp={self.fsdp} x tp={self.tp} x "
                f"sp={self.sp} = {dp * fixed} does not factor the "
                f"{n_devices} available devices; adjust the axis sizes "
                f"(--mesh dp=K,fsdp=M,tp=N,sp=S must multiply to "
                f"{n_devices}, or leave dp unset to absorb the remainder)"
            )
        return (dp, self.fsdp, self.tp, self.sp)

    @classmethod
    def parse(cls, spec) -> "MeshSpec":
        """``"dp=4,fsdp=2,tp=1"`` -> MeshSpec; unlisted axes default (dp=-1
        absorbs the remaining ranks). Typed errors on unknown axes and
        non-integer sizes."""
        if isinstance(spec, cls):
            return spec
        kwargs = {}
        for part in filter(None, (p.strip() for p in str(spec).split(","))):
            axis, _, value = part.partition("=")
            axis = axis.strip()
            if axis not in AXES:
                raise MeshConfigError(
                    f"unknown mesh axis {axis!r} in --mesh {spec!r} "
                    f"(axes: {', '.join(AXES)})"
                )
            try:
                kwargs[axis] = int(value)
            except ValueError:
                raise MeshConfigError(
                    f"mesh axis {axis} needs an integer size, got {value!r} "
                    f"(--mesh {spec!r})"
                ) from None
        return cls(**kwargs)

    def total(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp


class Mesh:
    """The grid of ``ranks`` (global ranks, row-major over ``AXES``) with
    this process's coordinates and a process group per axis (None for an
    axis of size 1), one over the batch extent (dp x fsdp), one over
    the replicas of a batch block (tp x sp: "replica") and one over the
    ranks that split the parameters (fsdp x tp: "shard"). Every rank
    of the default group builds every mesh, in the same order (group
    creation is collective); a rank outside ``ranks`` has no coordinates
    and must not train on it."""

    def __init__(self, sizes: Sequence[int], ranks: Sequence[int]):
        import torch.distributed as dist

        self.shape: Dict[str, int] = dict(zip(AXES, (int(s) for s in sizes)))
        self.devices = np.asarray(list(ranks), dtype=np.int64).reshape(tuple(self.shape.values()))
        self.device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(AXES, (int(c) for c in where[0]))) if len(where) else None)
        self.groups: Dict[str, object] = {}
        for axis in AXES + ("batch", "replica", "shard"):
            self.groups[axis] = self._new_group(axis)
        # checkpoint barriers ride their own gloo group: the writer thread
        # must not interleave with the step's collectives on the same group
        world = dist.get_world_size()
        self.ckpt_group = dist.new_group(backend="gloo") if world > 1 else None
        self._device_mesh = None

    def _members(self, axis: str):
        """Every group of ``axis`` as a list of global ranks, in coordinate
        order (the batch extent ordered dp-major, as JAX splits a batch over
        ("dp", "fsdp"))."""
        grid = self.devices
        if axis == "replica":  # the tp x sp ranks of one batch block, tp=sp=0 first
            s = grid.shape
            return [list(map(int, row)) for row in grid.reshape(s[0] * s[1], s[2] * s[3])]
        if axis == "shard":  # the fsdp x tp ranks of one (dp, sp) coordinate
            moved = np.moveaxis(grid, (0, 3), (0, 1))  # [dp, sp, fsdp, tp]
            return [list(map(int, moved[i, j].reshape(-1)))
                    for i in range(moved.shape[0]) for j in range(moved.shape[1])]
        if axis == "batch":
            moved = np.moveaxis(grid, (2, 3), (0, 1))  # [tp, sp, dp, fsdp]
            return [list(map(int, moved[i, j].reshape(-1)))
                    for i in range(moved.shape[0]) for j in range(moved.shape[1])]
        k = AXES.index(axis)
        moved = np.moveaxis(grid, k, -1)
        return [list(map(int, row)) for row in moved.reshape(-1, grid.shape[k])]

    def _new_group(self, axis: str):
        import torch.distributed as dist

        members = self._members(axis)
        if len(members[0]) == 1:
            return None
        mine = None
        for ranks in members:
            # every rank creates every group, in one order
            group = dist.new_group(ranks=ranks)
            if self.rank in ranks:
                mine = group
        return mine

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` of the grid, for DTensor callers (built on
        first use: its groups are collective, so every rank must ask)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(self.device_type, torch.as_tensor(self.devices),
                                           mesh_dim_names=AXES)
        return self._device_mesh

    # ------------------------------------------------------------- queries
    def size(self, axis: str) -> int:
        if axis == "replica":
            return self.shape["tp"] * self.shape["sp"]
        if axis == "shard":
            return self.shape["fsdp"] * self.shape["tp"]
        return self.shape["dp"] * self.shape["fsdp"] if axis == "batch" else self.shape[axis]

    def replica_lead(self) -> int:
        """The global rank at tp = sp = 0 of this rank's batch block."""
        c = self.coords
        return int(self.devices[c["dp"], c["fsdp"], 0, 0])

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (for "batch": dp-major over dp
        and fsdp, the block of the global batch it takes)."""
        c = self.coords
        if axis == "batch":
            return c["dp"] * self.shape["fsdp"] + c["fsdp"]
        return c[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


class _One:
    """The layout of one process on one device (a JAX learner's default
    mesh on one chip): every axis of size 1, this rank at 0."""

    shape = dict.fromkeys(AXES, 1)
    coords = dict.fromkeys(AXES, 0)

    def group(self, axis: str):
        return None


ONE_DEVICE = _One()


def make_mesh(spec: MeshSpec = MeshSpec(), devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of ``spec`` over ``devices`` (global ranks; default all of the
    default process group, which ``dist.dist_init`` forms as a world of one
    when none exists)."""
    import torch.distributed as dist

    from .dist import dist_init

    if not dist.is_initialized():
        dist_init(method="auto")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    sizes = spec.sizes(len(ranks))
    return Mesh(sizes, ranks)


def dp_axes(mesh):
    """The mesh axes the batch dimension shards over (fsdp doubles as data
    parallelism when > 1)."""
    return ("dp", "fsdp") if mesh.shape["fsdp"] > 1 else "dp"


def dp_extent(mesh) -> int:
    """Number of ways the batch dimension is split (dp, x fsdp when > 1)."""
    return mesh.shape["dp"] * mesh.shape["fsdp"]


def check_batch_divisible(mesh, batch_size: int, what: str = "batch") -> None:
    extent = dp_extent(mesh)
    if batch_size % extent:
        raise MeshConfigError(
            f"{what} size {batch_size} is not divisible by the mesh's "
            f"data-parallel extent dp x fsdp = {mesh.shape['dp']} x "
            f"{mesh.shape['fsdp']} = {extent}; pick a batch that is a "
            f"multiple of {extent} or a narrower mesh"
        )


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout over ``mesh``: ``spec[d]`` is None or the axis name(s) that
    split array dim d (JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: object
    spec: Tuple = ()

    def __str__(self) -> str:
        return spec_string(self.spec)

    def placements(self):
        """DTensor placements over the mesh's axes (Shard(d) where an axis
        splits dim d, Replicate otherwise)."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in AXES:
            dims = [d for d, names in enumerate(self.spec)
                    if names is not None and axis in (names if isinstance(names, tuple) else (names,))]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def spec_string(spec) -> str:
    """``str(jax.sharding.PartitionSpec(*spec))``."""
    def one(s):
        if s is None:
            return "None"
        if isinstance(s, tuple) and len(s) == 1:
            return repr(s[0])
        if isinstance(s, tuple):
            return "(" + ", ".join(repr(x) for x in s) + ("," if len(s) == 1 else "") + ")"
        return repr(s)

    return "PartitionSpec(" + ", ".join(one(s) for s in spec) + ("," if len(spec) == 1 else "") + ")"


def batch_sharding(mesh, batch_axis: int = 0, batch_size: Optional[int] = None) -> NamedSharding:
    """Shard the batch dimension over dp (and fsdp if > 1), replicate the
    rest; with ``batch_size`` the divisibility is checked here."""
    if batch_size is not None:
        check_batch_divisible(mesh, batch_size)
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = dp_axes(mesh)
    return NamedSharding(mesh, tuple(spec))


def time_batch_sharding(mesh) -> NamedSharding:
    """[T, B, ...] arrays: B (axis 1) over dp; T over sp on an sp mesh."""
    if mesh.shape["sp"] > 1:
        return NamedSharding(mesh, ("sp", dp_axes(mesh)))
    return NamedSharding(mesh, (None, dp_axes(mesh)))


def replicated_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def placement(sizes: Dict[str, int], names: Sequence[str], shape: Sequence[int]) -> Tuple:
    """The JAX learner's placement of one leaf: its spec (None or "tp" or
    "fsdp" per dim) from the axis sizes, its flax path ``names`` and its
    flax ``shape``. tp first: an attention QKV kernel ("Dense_0" under an
    "Attention*" module) splits its output dim, the output projection its
    input dim, any other leaf its largest tp-divisible dim; then fsdp takes
    the largest still-whole fsdp-divisible dim. A dim qualifies when the
    axis size divides it and it is at least twice the axis size; scalars
    replicate."""
    shape = tuple(int(d) for d in shape)
    if not shape:
        return ()
    ntp, nfsdp = int(sizes.get("tp", 1)), int(sizes.get("fsdp", 1))
    spec = [None] * len(shape)
    names = [str(n) for n in names]
    if ntp > 1:
        tp_dim = None
        in_attention = any(n.startswith("Attention") for n in names)
        if in_attention and names and names[-1] == "kernel" and len(shape) == 2:
            cand = 1 if any(n == "Dense_0" for n in names) else 0
            if shape[cand] % ntp == 0 and shape[cand] >= 2 * ntp:
                tp_dim = cand
        if tp_dim is None:
            best = None
            for i, d in enumerate(shape):
                if d % ntp == 0 and d >= 2 * ntp and (best is None or d > shape[best]):
                    best = i
            tp_dim = best
        if tp_dim is not None:
            spec[tp_dim] = "tp"
    if nfsdp > 1:
        best = None
        for i, d in enumerate(shape):
            if spec[i] is None and d % nfsdp == 0 and d >= 2 * nfsdp and (
                best is None or d > shape[best]
            ):
                best = i
        if best is not None:
            spec[best] = "fsdp"
    return tuple(spec)


def _tree_map_with_names(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_names(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_tree_map_with_names(fn, v, names + (f"[{i}]",)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    if tree is None:
        return None
    return fn(names, tree)


def param_sharding(mesh, tree):
    """A ``NamedSharding`` per leaf of a flax-layout tree (dicts, tuples;
    leaves with a ``shape``), by ``placement``."""
    sizes = dict(mesh.shape)
    return _tree_map_with_names(
        lambda names, x: NamedSharding(mesh, placement(sizes, names, getattr(x, "shape", ()))), tree)


def fsdp_param_sharding(mesh, tree):
    """Back-compat name of ``param_sharding``."""
    return param_sharding(mesh, tree)


def shrunk_spec(shape: Dict[str, int], batch_size: int) -> MeshSpec:
    """The spec ``shrink_dp`` shrinks a mesh of ``shape`` to: fsdp first,
    only as far as divisibility demands, then dp; tp and sp kept."""
    new_fsdp = math.gcd(batch_size, shape["fsdp"])
    new_dp = math.gcd(batch_size // new_fsdp, shape["dp"])
    return MeshSpec(dp=new_dp, fsdp=new_fsdp, tp=shape["tp"], sp=shape["sp"])


def shrink_dp(mesh, batch_size: int):
    """A mesh whose batch axes (dp, and fsdp when > 1) divide
    ``batch_size``, tp and sp kept; the mesh itself when it already fits.
    The new mesh takes the first ranks of the old one."""
    if batch_size % dp_extent(mesh) == 0:
        return mesh
    spec = shrunk_spec(mesh.shape, batch_size)
    devices = mesh.devices.reshape(-1)[: spec.total()]
    return make_mesh(spec, [int(d) for d in devices])
