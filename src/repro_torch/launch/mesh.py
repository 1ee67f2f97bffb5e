"""Mesh construction and sharding-constraint helpers (mirrors repro/launch/mesh.py).

The reference's JAX ``Mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
here: one process a rank, one card a rank (the CPU under ``gloo``). A
``PartitionSpec`` is a tuple of axis names, one a tensor dimension, and it
becomes DTensor placements on a mesh: a dimension named by a mesh axis is
``Shard(d)`` over it, every other mesh axis ``Replicate()``. The
constructors are FUNCTIONS (importing this module touches no process
group). Models call ``shard(x, ...)``, which is the identity unless a mesh
is active and ``x`` is a DTensor, so the same model code runs on one
device in tests and over a mesh of cards in the sharded engine.

Axis convention (the reference's):
  single-pod : (data=16, model=16)            axes ("data", "model")
  multi-pod  : (pod=2, data=16, model=16)     axes ("pod", "data", "model")
``pod`` is the outer data-parallel axis; ``BATCH`` shards over ("pod",
"data", "pool") where they exist.

Where plain tensors meet DTensors (the boundary the models keep): a
parameter tree placed by :func:`shard_model_params` holds DTensors; a step
turns its plain inputs into replicated DTensors where they first meet a
parameter (:func:`like`, :func:`take_rows`); products whose contraction was
split come back as partial sums, which :func:`reduced` adds across the mesh
at once, in f32 (``models.common.matmul_f32``); attention runs on each
rank's own heads as plain tensors (``models.attention``), as the kernels
take them; logits are gathered whole (:func:`whole`) before the argmax.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.optim.adamw import LAYER_STACK

AxisName = Union[str, tuple, None]

# canonical logical axes used throughout the model code
BATCH = ("pod", "data", "pool")  # batch / data-parallel (pool is inner DP)
MODEL = "model"  # tensor-parallel
POOL = "pool"  # weight-pooling cluster (shared-L2 analogue): the ZeRO shard axis


# ---------------------------------------------------------------------------
# the process group


def init_process_group(*, rank: Optional[int] = None, world_size: Optional[int] = None,
                       store: Optional[str] = None, backend: Optional[str] = None) -> int:
    """Start this process's rank of the process group the meshes span.

    The reference has no such call: JAX is single-controller, one process
    driving every device of its mesh. PyTorch runs one process a card, and
    each must join the group before a mesh can be built; this is that
    difference in the runtime, not a feature.

    With ``store`` (a file path) the ranks meet at a ``file://`` store,
    given ``rank`` and ``world_size``: no TCP port, so parallel test
    workers cannot collide. Without it, torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and its store). ``backend``: ``nccl``
    when a card is visible, ``gloo`` otherwise. Under ``nccl`` the rank's
    card (``LOCAL_RANK``, or the rank modulo the visible cards) becomes
    its current device. Returns the rank.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("a file store needs rank and world_size")
        init = f"file://{os.path.abspath(store)}"
    else:
        init = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if backend == "nccl":
        torch.cuda.set_device(rank_card(rank))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world_size)
    return rank


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks inside this one process, as
    its rank 0, over PyTorch's ``fake`` backend: every collective returns
    at once and moves nothing. For a cost walk on the meta device only
    (``launch.dryrun`` over the production meshes, 256 or 512 ranks):
    never in a process that serves or trains. The group is destroyed on
    the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_card(rank: Optional[int] = None) -> int:
    """The index of this rank's card: ``LOCAL_RANK`` where torchrun set it,
    else the rank modulo the visible cards (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank()
    return rank % max(1, torch.cuda.device_count())


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, worked out without
    making one (a cost walk would count a meta tensor of the global shape
    as live)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(d), 1)
    return tuple(reversed(out))


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with launch.mesh.init_process_group")
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


# ---------------------------------------------------------------------------
# meshes


def production_mesh_shape(*, multi_pod: bool = False, pool: int = 0) -> Tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh: 256 chips a pod as
    (data=16, model=16); 2 pods = 512. ``pool=k`` factors the data axis
    into (data=16/k, pool=k): a k-device weight-pooling cluster (the
    paper's k-core shared-L2 cluster). Batch shards over (pod, data, pool)
    either way, so the total data parallelism is unchanged."""
    if pool:
        assert 16 % pool == 0, pool
        shape = (2, 16 // pool, pool, 16) if multi_pod else (16 // pool, pool, 16)
        axes = ("pod", "data", "pool", "model") if multi_pod else ("data", "pool", "model")
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, pool: int = 0) -> DeviceMesh:
    """The production mesh over a process group of as many ranks as its
    shape holds (:func:`production_mesh_shape`)."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod, pool=pool)
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """An (n // model, model) ``("data", "model")`` mesh over every rank of
    the process group. ``model`` must divide the rank count: an
    (n // model, model) mesh would silently drop the remainder."""
    n = _world()
    if model < 1 or n % model != 0:
        dropped = n % model if model >= 1 else n
        raise ValueError(
            f"model={model} does not divide the {n} available devices; "
            f"an (n // model, model) mesh would silently drop {dropped} "
            "device(s). Pick a model-axis size that divides the device count."
        )
    return DeviceMesh(_device_type(), np.arange(n).reshape(n // model, model).tolist(),
                      mesh_dim_names=("data", "model"))


def make_serving_mesh(model: int = 1) -> DeviceMesh:
    """1-D ``("model",)`` mesh over the first ``model`` ranks, one card a
    rank (the CPU under ``gloo``). Unlike :func:`make_host_mesh` the model
    axis need not divide the rank count: a 2-shard replica on 4 ranks uses
    ranks 0 and 1. Every rank of the group calls it (making a sub-mesh is a
    collective); a rank past ``model`` gets a mesh it is not in
    (:func:`in_mesh`)."""
    n = _world()
    if model < 1 or model > n:
        raise ValueError(f"model={model} shards need {model} devices; host has {n}")
    return DeviceMesh(_device_type(), list(range(model)), mesh_dim_names=("model",))


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def local_size(n: int, mesh: Optional[DeviceMesh], axis: str = MODEL) -> int:
    """How many of ``n`` (heads) one rank holds when a dimension of size
    ``n`` is sharded over ``axis``: n / size when it divides, else all of
    them (the divisibility drop)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return n
    size = _axis_size(mesh, axis)
    return n // size if n % size == 0 else n


def shard_model_params(params: torch.nn.Module, mesh: DeviceMesh, axis: str = MODEL) -> torch.nn.Module:
    """A copy of the parameter module placed on ``mesh``: each leaf's LAST
    axis sharded over ``axis`` when divisible, replicated otherwise (the
    ``with_sharding_constraint``-style tensor-parallel layout, applied at
    placement time). Each rank copies only its own columns to its device,
    so a card holds ``shape[-1] / N`` columns of every divisible leaf; the
    input module, on any device, is left as it was. On a 1-device mesh
    this is a pure copy: every leaf comes back bit-identical."""
    if not in_mesh(mesh):
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    size = _axis_size(mesh, axis)
    mdim = mesh.mesh_dim_names.index(axis)
    coord = mesh.get_coordinate()[mdim]
    dev = mesh_device(mesh)
    memo = {}
    for p in params.parameters():
        if id(p) in memo:
            continue
        placements = [Replicate()] * mesh.ndim
        local = p.detach()
        if p.ndim >= 1 and size > 1 and p.shape[-1] % size == 0:
            placements[mdim] = Shard(p.ndim - 1)
            local = local.chunk(size, dim=-1)[coord]
        local = local.to(dev, copy=True).contiguous()
        d = DTensor.from_local(local, mesh, placements, run_check=False, shape=p.shape,
                               stride=contiguous_stride(p.shape))
        memo[id(p)] = torch.nn.Parameter(d, requires_grad=False)
    for m in params.modules():
        held = m.__dict__.get("_casts")
        if held is not None:
            memo[id(held)] = {}  # held casts belong to the source's leaves
    return copy.deepcopy(params, memo)


def leaf_spec(specs: dict, name: str) -> tuple:
    """The partition spec of the parameter ``name`` (a ``state_dict`` name)
    in a specs tree of the reference's shape: a layer of a stack
    (``layers.<i>.rest``) takes its stack's spec less the leading layer
    axis (:func:`layer_spec`), since the port holds a module a layer where
    the reference stacks them."""
    m = LAYER_STACK.match(name)
    path = [m.group(1), *name[m.end():].split(".")] if m else name.split(".")
    s = specs
    for k in path:
        s = s[k]
    return layer_spec(s) if m else tuple(s)


def layer_spec(stack: Sequence[AxisName]) -> tuple:
    """One layer's spec from its stack's: the stack's less its layer axis. A
    stack the specs shard along its layer axis (``pooled_specs`` pools
    qwen2-moe's (L, heads) attention biases so: L is their only unsharded
    dim) has no per-layer form of that axis, so each layer's leaf shards
    its own first dim over those axes too, beside its own: a rank then
    holds the same share of the stack, 1/pool of it. (Where that dim does
    not divide, the divisibility drop holds the leaf whole over both.)"""
    stack = tuple(stack)
    if len(stack) < 2 or stack[0] is None:
        return stack[1:]
    axes = lambda a: () if a is None else (a if isinstance(a, tuple) else (a,))
    return ((*axes(stack[1]), *axes(stack[0])),) + stack[2:]


def distribute(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[AxisName],
               device: Optional[torch.device] = None) -> torch.Tensor:
    """``x``, the same whole tensor on every rank, as a DTensor on ``mesh``
    placed at the partition spec ``axes`` (the divisibility drop applied):
    each rank copies only its own slice to ``device`` (default the mesh's),
    with no collective; ``x`` itself is left as it was. A meta ``x`` (the
    dry run's) stays on meta by default."""
    place = placements(mesh, axes, x.shape)
    local = x.detach()[local_index(x.shape, mesh, place)]
    if device is None:
        device = x.device if x.is_meta else mesh_device(mesh)
    local = local.to(device, copy=True).contiguous()
    return DTensor.from_local(local, mesh, place, run_check=False, shape=x.shape,
                              stride=contiguous_stride(x.shape))


def local_index(shape, mesh: DeviceMesh, place) -> tuple:
    """This rank's slice of a whole array of ``shape`` under the DTensor
    placements ``place`` (even shards, as :func:`placements` leaves them;
    a dimension sharded over several mesh axes splits in mesh-axis order),
    as a tuple of slices: an index into a tensor or a numpy array (a
    memory-mapped ``.npy`` reads only those rows)."""
    lo, hi = [0] * len(shape), list(shape)
    for i, p in enumerate(place):
        if p.is_shard():
            n = (hi[p.dim] - lo[p.dim]) // int(mesh.size(i))
            lo[p.dim] += n * mesh.get_local_rank(i)
            hi[p.dim] = lo[p.dim] + n
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def place_params(params: torch.nn.Module, mesh: DeviceMesh, specs: dict) -> torch.nn.Module:
    """A copy of the parameter module placed on ``mesh`` at ``specs`` (a
    specs tree of the reference's shape, e.g. ``ModelAPI.param_specs()`` or
    ``core.pooling.pooled_specs``): the counterpart of the reference's
    ``jax.device_put(params, tree_shardings(mesh, specs))``. Each rank
    copies only its own slice of every leaf to its device
    (:func:`distribute`); the input module, on any device, is left as it
    was, and the copy holds no cast of the source's."""
    if not in_mesh(mesh):
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    memo = {}
    for name, p in params.named_parameters():
        if id(p) not in memo:
            memo[id(p)] = torch.nn.Parameter(distribute(p, mesh, leaf_spec(specs, name)),
                                             requires_grad=False)
    for m in params.modules():
        held = m.__dict__.get("_casts")
        if held is not None:
            memo[id(held)] = {}  # held casts belong to the source's leaves
    return copy.deepcopy(params, memo)


def mesh_of(tensors) -> Optional[DeviceMesh]:
    """The mesh of the first DTensor among ``tensors``; None if none is one."""
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


# ---------------------------------------------------------------------------
# active-mesh context (thread-local; no global process-group state)

_local = threading.local()


def active_mesh() -> Optional[DeviceMesh]:
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def activate(mesh: Optional[DeviceMesh]):
    prev = active_mesh()
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def _filter_spec(axes: Sequence[AxisName], names) -> tuple:
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif isinstance(a, tuple):
            kept = tuple(n for n in a if n in names)
            out.append(kept if kept else None)
        else:
            out.append(a if a in names else None)
    return tuple(out)


def spec(*axes: AxisName, mesh: Optional[DeviceMesh] = None) -> tuple:
    """The partition spec (a tuple, one entry a dimension) with the axes
    not present in the mesh dropped."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return tuple(axes)
    return _filter_spec(axes, set(mesh.mesh_dim_names))


def placements(mesh: DeviceMesh, axes: Sequence[AxisName], shape=None) -> list:
    """DTensor placements for a tensor of ``shape`` under the spec ``axes``:
    each mesh axis named at dimension d shards it, every other mesh axis
    replicates. With ``shape``, an axis whose size does not divide its
    dimension is dropped (the divisibility drop)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for i, a in enumerate(axes):
        if a is None or (shape is not None and i >= len(shape)):
            continue
        kept = [n for n in (a if isinstance(a, tuple) else (a,)) if n in names]
        total = int(np.prod([_axis_size(mesh, n) for n in kept])) if kept else 0
        if not kept or (shape is not None and (total == 0 or shape[i] % total != 0)):
            continue
        for n in kept:
            out[names.index(n)] = Shard(i)
    return out


def shard(x: torch.Tensor, *axes: AxisName) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placement ``axes`` name if a
    mesh is active; the identity with no active mesh and on a plain tensor.

    Divisibility-aware: any requested axis whose size does not divide the
    corresponding dimension is dropped (e.g. 2 KV heads on a 4-way model
    axis stay replicated rather than erroring)."""
    if active_mesh() is None or not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, axes, x.shape)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec: the reference's ``NamedSharding``."""

    mesh: DeviceMesh
    spec: tuple

    def placements(self, shape) -> list:
        return placements(self.mesh, self.spec, shape)


def named(mesh: DeviceMesh, *axes: AxisName) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(axes, set(mesh.mesh_dim_names)))


def tree_shardings(mesh: DeviceMesh, specs):
    """Map a nest of dicts of partition specs (tuples) to NamedShardings on
    ``mesh``."""
    if isinstance(specs, dict):
        return {k: tree_shardings(mesh, v) for k, v in specs.items()}
    return named(mesh, *specs)


# ---------------------------------------------------------------------------
# the plain-to-DTensor boundary


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def replicated(x: torch.Tensor, mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """A plain ``x``, the same on every rank, as a tensor replicated on
    ``mesh`` (by default the active mesh: where a plain input first meets
    the placed parameters); a DTensor, or any tensor with no mesh, as it
    is."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain ``t`` as a tensor replicated on ``ref``'s mesh when ``ref`` is
    a DTensor (every rank holds the same ``t``); otherwise ``t``."""
    return replicated(t, ref.device_mesh) if isinstance(ref, DTensor) else t


def rows_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain ``t`` holding rows of ``ref``'s batch (dim 0) as a tensor on
    ``ref``'s mesh: where ``ref`` is split on dim 0 (over the data axes)
    and ``t`` holds this rank's rows of it (a cache's shift or length, kept
    a rank's rows), split on dim 0 as ``ref`` is and replicated elsewhere;
    where ``t`` holds every row, or ``ref`` is not split, :func:`like`."""
    if not isinstance(ref, DTensor) or not any(p.is_shard(0) for p in ref.placements) or \
            t.shape[0] == ref.shape[0]:
        return like(t, ref)
    place = [Shard(0) if p.is_shard(0) else Replicate() for p in ref.placements]
    return from_local(t, ref.device_mesh, place, (ref.shape[0],) + tuple(t.shape[1:]))


def common(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` on one footing: a plain one beside a DTensor becomes
    replicated on its mesh."""
    return like(a, b), like(b, a)


def reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor of partial sums (a product whose contraction was split
    across the mesh) added across it, in its own dtype, to a replicated
    whole; anything else as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in x.placements])
    return x


def replicated_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor sharded along ``dim`` gathered along it (a D-sharded
    residual before a norm over D); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


def split_last(x: torch.Tensor, sizes: tuple) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *sizes)``. A DTensor sharded along its last
    dimension keeps the shard on the first new dimension when the mesh
    divides it, and is gathered along it first when it does not (a
    column shard that would cut a head in two)."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        for i, p in enumerate(x.placements):
            if p.is_shard(last) and sizes[0] % x.device_mesh.size(i) != 0:
                x = replicated_dim(x, last)
                break
    return x.reshape(*x.shape[:-1], *sizes)


def take_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``w[ids]``: the rows of a table. A DTensor table is looked up on each
    rank's shard, on each rank's ids (a batch sharded over the data axes
    stays so), by ``w[ids]`` where the rank holds every row (a 1-card mesh
    runs the plain path's op) and ``F.embedding`` where it holds some: a
    rank of a vocabulary-sharded table gives the rows it holds and zeros
    for the others, and the rows are added across the mesh (each row lives
    on one rank, so the sum is exact); a table sharded along its width
    gives the rows' columns."""
    if not isinstance(w, DTensor):
        return w[ids.long()]
    ids = like(ids.long(), w)
    mesh, out, n = w.device_mesh, [], w.shape[0]
    for pw, pi in zip(w.placements, ids.placements):
        if pw.is_shard(0):
            out.append(Partial())
        elif pw.is_shard(1):
            out.append(Shard(ids.ndim))
        else:
            out.append(pi)
    rows = local_index(w.shape, mesh, w.placements)[0]
    wl = w.to_local(grad_placements=grad_placements(w, ids))
    il = ids.to_local()
    if (rows.start, rows.stop) == (0, n):  # the whole table: the plain path's own op
        local = wl[il]
    else:
        keep = (il >= rows.start) & (il < rows.stop)
        local = torch.where(keep[..., None], F.embedding((il - rows.start).clamp(0, wl.shape[0] - 1), wl), 0.0)
    return reduced(from_local(local, mesh, out, tuple(ids.shape) + (w.shape[1],)))


def _over_model(ndim: int, dim: int) -> tuple:
    axes = [None] * ndim
    axes[dim % ndim] = MODEL
    return tuple(axes)


def _heads_placements(mesh: DeviceMesh, dim: int, shape, keep=None) -> list:
    """Placements with ``dim`` over ``MODEL`` where it divides (replicated
    where it does not) and every other mesh axis as in ``keep`` (a DTensor's
    placements: a batch sharded over the data axes stays so), replicated
    without it."""
    out = placements(mesh, _over_model(len(shape), dim), shape)
    if keep is not None and MODEL in (mesh.mesh_dim_names or ()):
        m = mesh.mesh_dim_names.index(MODEL)
        out = [o if i == m else k for i, (o, k) in enumerate(zip(out, keep))]
    return out


def grad_placements(x: DTensor, ref: Optional[DTensor]) -> list:
    """The placements of the gradient of ``x``'s local tensor when each rank
    computes with it beside ``ref``'s local tensor: over a mesh axis that
    shards ``ref`` but replicates ``x`` (a weight beside a batch sharded
    over the data axes, K/V beside queries split over ``MODEL``) each rank's
    gradient is a partial sum; elsewhere the gradient is placed as ``x``."""
    if ref is None:
        return list(x.placements)
    return [Partial() if p.is_replicate() and not r.is_replicate() else p
            for p, r in zip(x.placements, ref.placements)]


def local_heads(x: torch.Tensor, dim: int, like: Optional[DTensor] = None) -> torch.Tensor:
    """This rank's share of ``x`` along ``dim`` (the heads a kernel runs on)
    as a plain tensor: the slice ``MODEL`` gives it where the axis divides
    the dimension, all of it where it does not (the divisibility drop);
    every other mesh axis keeps its placement (a batch sharded over the
    data axes stays so). ``x`` a DTensor, or a plain tensor the same on
    every rank; with no active mesh ``x`` as it is. A replicated input is
    sliced locally, with no collective. ``like``, the activation the local
    computation runs beside, gives the gradient's placements
    (:func:`grad_placements`)."""
    x = to_heads(x, dim)
    return x.to_local(grad_placements=grad_placements(x, like)) if isinstance(x, DTensor) else x


def to_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`local_heads` before its last step: ``x`` as a DTensor with
    ``dim`` over ``MODEL`` where the axis divides it, every other mesh axis
    as placed; with no active mesh ``x`` as it is."""
    if active_mesh() is None:
        return x
    x = replicated(x)
    want = _heads_placements(x.device_mesh, dim, x.shape, x.placements)
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


def local_rows(x: torch.Tensor, like: Optional[DTensor] = None) -> torch.Tensor:
    """This rank's share of ``x`` as a plain tensor, gathered over ``MODEL``
    and placed as it is over every other mesh axis: an activation's own
    batch rows with every channel, or a parameter whole (a depthwise conv
    runs on whole channels). ``like`` gives the gradient's placements
    (:func:`grad_placements`: a weight used beside rows split over the
    data axes takes a partial gradient). A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    want = [Replicate() if n == MODEL else p for n, p in zip(names, x.placements)]
    if list(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local(grad_placements=grad_placements(x, like))


def pooled(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor split over the ``POOL`` axis (a leaf at
    its pooled storage layout)."""
    return isinstance(x, DTensor) and POOL in (x.device_mesh.mesh_dim_names or ()) and \
        x.placements[x.device_mesh.mesh_dim_names.index(POOL)].is_shard()


def unpooled(x: torch.Tensor) -> torch.Tensor:
    """A pooled leaf gathered over ``POOL`` (every other axis as placed):
    what a path that reads a parameter as stored, with no compute spec of
    its own, computes with; anything else as it is."""
    if not pooled(x):
        return x
    i = x.device_mesh.mesh_dim_names.index(POOL)
    return x.redistribute(x.device_mesh, [Replicate() if j == i else p for j, p in enumerate(x.placements)])


def first_index(x: DTensor, dim: int) -> int:
    """The global index of a DTensor's first local entry along ``dim``
    (evenly sharded, as the placements here leave it)."""
    start = 0
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            start = start * x.device_mesh.size(i) + x.device_mesh.get_local_rank(i)
    return start * x.to_local().shape[dim]


def from_heads(x: torch.Tensor, dim: int, shape, mesh: Optional[DeviceMesh] = None,
               like: Optional[DTensor] = None) -> torch.Tensor:
    """:func:`local_heads`'s inverse: a rank's share along ``dim`` as a
    DTensor of global ``shape`` on ``mesh`` (by default the active mesh),
    sharded along ``dim`` over ``MODEL`` where it divides, replicated where
    it does not, every other mesh axis placed as ``like`` (the activation
    it came from) where given; ``x`` as it is with no mesh."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        return x
    shape = torch.Size(shape)
    keep = like.placements if isinstance(like, DTensor) else None
    return DTensor.from_local(x, mesh, _heads_placements(mesh, dim, shape, keep), run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose backward hands each rank the gradient of
    its local tensor: the incoming gradient placed as the output was, a
    partial output's gradient whole (a partial sum's every term takes the
    whole gradient; DTensor's own ``from_local`` passes a partial gradient
    on as it came)."""

    @staticmethod
    def forward(ctx, x, mesh, place, shape):
        ctx.mesh, ctx.place = mesh, [Replicate() if p.is_partial() else p for p in place]
        shape = torch.Size(shape)
        return DTensor.from_local(x, mesh, place, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, grad):
        if list(grad.placements) != ctx.place:
            grad = grad.redistribute(ctx.mesh, ctx.place)
        return grad.to_local(), None, None, None


def from_local(x: torch.Tensor, mesh: DeviceMesh, place, shape) -> DTensor:
    """A rank's local result ``x`` as a DTensor of global ``shape`` on
    ``mesh``, placed at ``place`` (:class:`_FromLocal`)."""
    return _FromLocal.apply(x, mesh, list(place), tuple(shape))


def local_matmul(a: DTensor, b: DTensor, fn=torch.matmul) -> DTensor:
    """``fn(a, b)`` (a matmul, (..., M, K) @ (K, N) or (..., K, N)) computed
    on each rank's local shards, the placements worked out here, mesh axis
    by mesh axis: a batch or row shard of ``a`` stays on the output (the
    weight gathered where it is split on the same axis), a column shard of
    ``b`` gives an output column shard, and a split contraction (the other
    operand sliced to it locally where it is whole) gives a partial sum.
    Each rank runs the plain ``fn`` on plain tensors (so a 1-card mesh runs
    exactly the plain path's kernel), and the gradients' placements follow
    (:func:`grad_placements`). DTensor's own propagation of a product over
    a mesh of three axes takes seconds a shape on the host. A ``ValueError``
    where the operands fall outside these cases (b's batch axes split, a
    split where it broadcasts against b's): no model makes such a product."""
    mesh = a.device_mesh
    if b.device_mesh != mesh or a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"a product of {a.ndim}-D by {b.ndim}-D operands on one mesh is needed")
    a, b = reduced(a), reduced(b)
    ka, kb, nb = a.ndim - 1, b.ndim - 2, b.ndim - 1
    if any(p.is_shard() and p.dim < kb for p in b.placements) or (
            b.ndim > 2 and any(p.is_shard() and p.dim < a.ndim - 2 for p in a.placements)):
        raise ValueError(f"batch dims split across cards: {a.placements} @ {b.placements}")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) if b.ndim > 2 else a.shape[:-2]
    shape = tuple(batch) + (a.shape[-2], b.shape[-1])
    shift = len(shape) - a.ndim
    want_a, want_b, out = list(a.placements), list(b.placements), []
    for i, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        a_k, b_k, b_n = pa.is_shard(ka), pb.is_shard(kb), pb.is_shard(nb)
        a_row = pa.is_shard() and not a_k
        if a_row and (b_k or b_n):  # both split on this axis: gather the weight
            want_b[i], b_k, b_n = Replicate(), False, False
        if a_k and b_n:  # a's contraction split against b's columns: gather a's
            want_a[i], a_k = Replicate(), False
        if a_k and not b_k:
            want_b[i], b_k = Shard(kb), True
        elif b_k and not a_k:
            want_a[i], a_k = Shard(ka), True
        if a_k:
            out.append(Partial())
        elif a_row:
            out.append(Shard(pa.dim + shift))
        elif b_n:
            out.append(Shard(len(shape) - 1))
        else:
            out.append(Replicate())
    if want_a != list(a.placements):
        a = a.redistribute(mesh, want_a)
    if want_b != list(b.placements):
        b = b.redistribute(mesh, want_b)
    al = a.to_local(grad_placements=grad_placements(a, b))
    bl = b.to_local(grad_placements=grad_placements(b, a))
    return from_local(fn(al, bl), mesh, out, shape)


def local_einsum(eq: str, x: DTensor, w: torch.Tensor) -> Optional[DTensor]:
    """``torch.einsum(eq, x, w)`` on each rank's local shard of ``x`` beside
    a ``w`` whole on every rank (replicated, or plain): a shard of ``x``
    stays on the output dimension of its letter, or gives a partial sum
    where its letter is summed. None where ``w`` is split."""
    w = like(w, x)
    if w.device_mesh != x.device_mesh or any(not p.is_replicate() for p in w.placements):
        return None
    x = reduced(x)
    ins, os_ = eq.split("->")
    xs, ws = ins.split(",")
    out = [Replicate() if not p.is_shard() else (Shard(os_.index(xs[p.dim])) if xs[p.dim] in os_ else Partial())
           for p in x.placements]
    sizes = dict(zip(xs, x.shape))
    sizes.update(zip(ws, w.shape))
    local = torch.einsum(eq, x.to_local(), w.to_local(grad_placements=grad_placements(w, x)))
    return from_local(local, x.device_mesh, out, [sizes[c] for c in os_])


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank, as a plain tensor (the
    vocabulary-sharded logits before the argmax); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def gathered(x: torch.Tensor, mesh: DeviceMesh, dim: int) -> torch.Tensor:
    """Every rank's local ``x`` concatenated along ``dim`` in rank order
    (an all-gather over the 1-D ``mesh``), as a plain tensor."""
    return DTensor.from_local(x, mesh, [Shard(dim)], run_check=False).full_tensor()


def all_reduce_host(values, mesh: DeviceMesh, op: str = "sum", dtype=np.int64) -> np.ndarray:
    """One all-reduce of a host vector over the 1-D ``mesh``: the sum (or
    max) of every rank's ``values``, read back to the host."""
    from repro_torch.device import to_device, to_host

    tdt = torch.int64 if np.dtype(dtype) == np.int64 else torch.float64
    t = to_device(np.asarray(values, dtype).reshape(-1), tdt, mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.get_group())
    return to_host(t).astype(dtype)
