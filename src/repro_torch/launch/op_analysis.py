"""Op-level cost walk of one eager call: the port's counterpart of the
reference's ``launch/hlo_analysis.py``.

The reference parses the compiled HLO text. PyTorch runs eagerly and has no
HLO, so the walk is a ``TorchDispatchMode`` over one call of the step on the
meta device: every aten op the call dispatches (its backward and optimizer
update included) passes through :meth:`CostWalk.__torch_dispatch__`, runs
on meta (shapes only, nothing allocated), and is priced:

* flops: products, convolutions and SDPA by ``torch.utils.flop_counter``'s
  formulas (2 M N K a product); each elementwise op that the reference's
  ``_ELEMENTWISE_FLOPS`` lists, under its aten name (``ELEMENTWISE``), one
  flop an output element; a reduction half an operand element, as the
  reference's ``reduce``. Kept by the dtype of the op's inputs
  (``flops_by_dtype``), products also apart (``product_flops_by_dtype``):
  the dtype decides the unit a product runs on;
* bytes: in eager mode every op is a round trip through device memory, so
  each op that is not a view counts the bytes of its tensor operands and
  outputs (an expanded operand its distinct elements only); a gather reads
  and writes its output's size and a scatter its update's, as the
  reference's slice-aware rule;
* the kernels: a kernel wrapper inside the walk takes its shape-only route
  and records its ``kernels/work.py`` count here (``kernel``), kept per
  kernel in ``tagged_bytes`` / ``tagged_flops`` (the reference's tag for
  ``flash_attention_ref``), with its calls and its time at its own peak;
* peak live bytes: every storage on the meta device from the moment an
  op (or the call's arguments: parameters, optimizer state, inputs, held
  casts) brings it in to the moment its last reference drops (a
  finalizer on the storage), so saved activations count while autograd
  holds them;
* collectives: ``_c10d_functional`` ops counted by kind under the
  reference's names, each with the size of its group and the link its
  group crosses (``link_of``: NVLink inside a node of 8 consecutive ranks,
  InfiniBand across nodes), read from the group's ranks. One card has none.

Across a mesh (the dry run over the production meshes, a fake process
group of 256 or 512 ranks in one process, ``launch.mesh.fake_process_group``)
the step runs on DTensors whose local tensors are this rank's (rank 0's)
shards on meta. An op on DTensors is priced at its local tensors: its
flops and bytes are rank 0's, and so are the live bytes (per card, as the
reference's ``memory_analysis()`` is per device). A redistribution the
models ask for (``launch.mesh``) issues functional collectives, which the
walk sees; one DTensor inserts inside an op's own dispatch is not seen.

``walk(fn, *args)`` returns ``(fn's result, Cost)``.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

aten = torch.ops.aten

# aten op -> the reference's HLO op of _ELEMENTWISE_FLOPS it counts as
# (in-place forms, ``add_``, count as their op)
ELEMENTWISE = {
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply", "div": "divide",
    "maximum": "maximum", "minimum": "minimum", "pow": "power", "exp": "exponential", "log": "log",
    "tanh": "tanh", "rsqrt": "rsqrt", "sqrt": "sqrt", "neg": "negate", "abs": "abs", "cos": "cosine",
    "sin": "sine", "floor": "floor", "ceil": "ceil", "round": "round-nearest-afz", "expm1": "expm1",
    "log1p": "log1p", "sigmoid": "logistic", "silu": "logistic", "gelu": "tanh", "atan2": "atan2",
    "remainder": "remainder", "where": "select", "clamp": "clamp", "clamp_min": "clamp",
    "clamp_max": "clamp", "eq": "compare", "ne": "compare", "lt": "compare", "le": "compare",
    "gt": "compare", "ge": "compare", "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
    "logical_not": "not", "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_not": "not",
}
TRANSCENDENTAL = {"exponential", "log", "tanh", "rsqrt", "sqrt", "logistic", "expm1", "log1p", "cosine",
                  "sine", "power"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "prod", "logsumexp", "var", "std", "linalg_vector_norm",
              "argmax", "argmin", "any", "all"}
# ops that read what they select (the output's size) and write it
GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# in-place ops that write only the update's elements of their first operand
SCATTERS = {"index_put_", "scatter_", "scatter_add_", "index_add_", "index_copy_", "index_fill_"}
# ops that move no data: views, and allocations that write nothing
NO_TRAFFIC = {"_unsafe_view", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
              "new_empty", "new_empty_strided", "resize_", "set_", "wait_tensor", "_wrap_tensor_autograd"}
# mutating ops whose written operand they do not read
WRITE_ONLY = {"copy_", "fill_", "zero_"}
COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
NODE = 8  # cards a node (a DGX H100), joined by NVLink; nodes by InfiniBand


def link_of(ranks) -> str:
    """The link a collective over ``ranks`` crosses: ``nvlink`` when they
    all lie in one node of ``NODE`` consecutive ranks, ``ib`` otherwise."""
    ranks = list(ranks)
    return "nvlink" if min(ranks) // NODE == max(ranks) // NODE else "ib"


def _group_ranks(args) -> list:
    """The ranks of a functional collective's group, its last argument the
    group's name, which the running process group must resolve."""
    from torch.distributed.distributed_c10d import _resolve_process_group, get_process_group_ranks

    return get_process_group_ranks(_resolve_process_group(args[-1]))


@dataclasses.dataclass
class Cost:
    """The walk's totals, under the reference's field names
    (``hlo_analysis.Cost``) and the port's own: flops by dtype, the
    kernels' calls and time, peak live bytes."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    collective_ops: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    # the port's: each (kind, group size, link) apart, {"bytes", "ops"}
    collectives: Dict[str, dict] = dataclasses.field(default_factory=dict)
    tagged_bytes: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    tagged_flops: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    # the port's: aten flops by input dtype, products among them apart;
    # each kernel's calls and its time at the peak kernels/work.py gives it
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    product_flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    kernel_seconds: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0
    ops: int = 0

    @property
    def group_sizes(self) -> Dict[str, float]:
        """The largest group of each kind (the reference's field), from
        ``collectives``."""
        out: Dict[str, float] = {}
        for e in self.collectives.values():
            out[e["kind"]] = max(out.get(e["kind"], 0.0), float(e["group"]))
        return out

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {k: dict(v) if isinstance(v, dict) else v for k, v in dataclasses.asdict(self).items()}


@dataclasses.dataclass(frozen=True)
class _Rule:
    """How one aten overload is priced, worked out once."""

    name: str
    moves: bool  # False for views and allocations that write nothing
    flop_formula: object  # torch.utils.flop_counter's formula, or None
    elementwise: str  # the reference's HLO op it counts as, or ""
    reduction: bool
    collective: str  # the reference's collective kind, or ""
    written: tuple  # (position, name) of the operands it writes
    write_only: bool  # it does not read what it writes


_RULES: Dict[object, _Rule] = {}


def _rule(func) -> _Rule:
    rule = _RULES.get(func)
    if rule is None:
        name = func._overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and name[:-1] in ELEMENTWISE else name
        schema = func._schema
        rule = _RULES[func] = _Rule(
            name=name,
            moves=not (func.is_view or name in NO_TRAFFIC),
            flop_formula=flop_registry.get(func._overloadpacket),
            elementwise=ELEMENTWISE.get(base, ""),
            reduction=name in REDUCTIONS,
            collective=COLLECTIVES.get(name, ""),
            written=tuple((i, a.name) for i, a in enumerate(schema.arguments)
                          if a.alias_info is not None and a.alias_info.is_write),
            write_only=name in WRITE_ONLY or schema.overload_name == "out",
        )
    return rule


def _touched_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its distinct elements (an
    expanded tensor's stride-0 dims repeat one element)."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()) if s > 1)
    return min(n, span) * t.element_size()


def _flat(x, out: list) -> list:
    """The tensors in ``x``: a tensor, or nested lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _dtype_of(tensors) -> str:
    for t in tensors:
        if t.is_floating_point():
            return str(t.dtype)[6:]
    return str(tensors[0].dtype)[6:] if tensors else "none"


def _local(x):
    return x._local_tensor if isinstance(x, DTensor) else x


def held_tensors(obj) -> list:
    """Every tensor a call's arguments hold: a module's parameters, buffers
    and held casts (``common.cast``), and the leaves of dicts, lists and
    tuples; a DTensor's local tensor (this rank's shard)."""
    out = []
    if isinstance(obj, torch.Tensor):
        out.append(_local(obj))
    elif isinstance(obj, torch.nn.Module):
        for m in obj.modules():
            out += list(m.parameters(recurse=False)) + list(m.buffers(recurse=False))
            out += [entry[1] for entry in m.__dict__.get("_casts", {}).values()]
        out = [_local(t) for t in out]
    elif isinstance(obj, dict):
        for v in obj.values():
            out += held_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out += held_tensors(v)
    return out


class CostWalk(TorchDispatchMode):
    """Prices every aten op dispatched while it is active (see the module
    docstring), and registers itself with the kernel wrappers
    (``build.WALKS``) so that they record their work instead of launching."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: Dict[int, int] = {}
        self.live_bytes = 0

    # -- live storages ---------------------------------------------------
    def _free(self, key: int):
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, tensors):
        """Count each new storage on the meta device as live until its last
        reference drops."""
        for t in tensors:
            if not t.is_meta:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += self._live[key]
            weakref.finalize(st, self._free, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live_bytes)

    # -- kernels -----------------------------------------------------------
    def kernel(self, name: str, work):
        nbytes, ops, peak = work
        c = self.cost
        c.bytes += nbytes
        c.flops += ops
        c.tagged_bytes[name] += nbytes
        c.tagged_flops[name] += ops
        c.kernel_calls[name] += 1
        c.kernel_seconds[name] += ops / peak

    # -- aten ops -----------------------------------------------------------
    def _price(self, func, args, kwargs, ins, out, outs):
        c = self.cost
        rule = _rule(func)
        c.ops += 1
        if rule.collective:
            nbytes = sum(_touched_bytes(t) for t in ins)  # the operands, as the reference's
            ranks = _group_ranks(args)
            c.collective_bytes[rule.collective] += nbytes
            c.collective_ops[rule.collective] += 1
            key = f"{rule.collective}/{len(ranks)}/{link_of(ranks)}"
            entry = c.collectives.setdefault(key, {"kind": rule.collective, "group": len(ranks),
                                                   "link": link_of(ranks), "bytes": 0.0, "ops": 0})
            entry["bytes"] += nbytes
            entry["ops"] += 1
        if not rule.moves:
            return
        dtype = _dtype_of(ins)
        flops = 0.0
        if rule.flop_formula is not None:
            flops = float(rule.flop_formula(*args, **kwargs, out_val=out))
            c.product_flops_by_dtype[dtype] += flops
        elif rule.elementwise and outs:
            flops = float(sum(t.numel() for t in outs))
            if rule.elementwise in TRANSCENDENTAL:
                c.transcendentals += flops
        elif rule.reduction and ins:
            flops = ins[0].numel() / 2
        c.flops += flops
        c.flops_by_dtype[dtype] += flops
        if rule.name in GATHERS:
            c.bytes += 2.0 * sum(_touched_bytes(t) for t in outs)
            return
        if rule.name in SCATTERS:
            upd = args[2] if rule.name == "index_put_" else args[-1]
            if isinstance(upd, (list, tuple)):
                upd = upd[0]
            c.bytes += 2.0 * (_touched_bytes(upd) if isinstance(upd, torch.Tensor) else 0)
            return
        skip = ()
        if rule.write_only:
            skip = {id(v) for v in (args[i] if i < len(args) else kwargs.get(n) for i, n in rule.written)
                    if isinstance(v, torch.Tensor)}
        c.bytes += float(sum(_touched_bytes(t) for t in ins if id(t) not in skip)
                         + sum(_touched_bytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # an op on DTensors is priced at this rank's local tensors
        args, kwargs, priced = tree_map(_local, args), tree_map(_local, kwargs), tree_map(_local, out)
        ins, outs = _flat(kwargs, _flat(args, [])), _flat(priced, [])
        self.track(ins)
        self._price(func, args, kwargs, ins, priced, outs)
        self.track(outs)
        return out

    def __enter__(self):
        build.WALKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.WALKS.remove(self)
        return super().__exit__(*exc)


def walk(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` on meta tensors once under a
    :class:`CostWalk`, the tensors its arguments hold counted live from the
    start. Returns (fn's result, Cost)."""
    w = CostWalk()
    w.track(held_tensors(args) + held_tensors(kwargs))
    with w:
        result = fn(*args, **kwargs)
    return result, w.cost
