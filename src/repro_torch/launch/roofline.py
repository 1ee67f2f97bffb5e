"""Roofline terms from a cost walk (NVIDIA H100 80GB HBM3, 700 W target).

The port's counterpart of the reference's ``launch/roofline.py``: per (arch
x shape) cell the same three terms, in seconds a step on one card, from
``launch/op_analysis.Cost`` at the card's figures (``core/hw.py``):

  compute term    = sum over ops of flops / (the peak of the unit they run on)
  memory term     = bytes / HBM_BW
  collective term = each collective's wire bytes / the bandwidth of the link
                    its group crosses (ring model; 0 on one card)

The compute term prices each product at the peak of the unit its input
dtype runs on: bf16 (and fp16) products on the tensor cores at their bf16
peak, f32 products on the CUDA cores, since TF32 stays off (the port's
products are f32-exact); every other aten op at the CUDA cores' f32 peak;
each kernel at the peak ``kernels/work.py`` gives it. ``detail
["compute_at_bf16_s"]`` is the reference's compute term, every flop at the
bf16 peak: the gap between the two is what bf16 products could win.

The walk already counts the kernels' own traffic in place of an eager
attention's (the kernels record their ``kernels/work.py`` bytes, and
nothing of a score matrix reaches device memory), so
``memory_kernel_adj_s`` equals ``memory_s``.

A collective's link: its group inside one node of 8 consecutive ranks
rides NVLink (``hw.NVLINK_BW``), any other InfiniBand (``hw.IB_BW``), the
counterpart of the reference's ICI and cross-pod DCI figures. On the
production meshes the model axis (16 consecutive ranks) spans two nodes,
so its collectives price at InfiniBand; the data and pool axes (stride 16)
span nodes too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import hw
from repro_torch.launch.op_analysis import Cost

# the peak a product of each input dtype runs at (TF32 off: f32 on the CUDA cores)
PRODUCT_PEAK = {"bfloat16": hw.PEAK_FLOPS_BF16, "float16": hw.PEAK_FLOPS_BF16}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    collective_bytes: float
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (walked flops * chips)
    bound: str
    detail: Dict[str, float]
    # the reference's kernel-adjusted memory term; the walk counts the
    # kernels' traffic itself, so it equals memory_s
    memory_kernel_adj_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def compute_seconds(cost: Cost) -> float:
    """Every op's flops over the peak of the unit it runs on."""
    products = sum(cost.product_flops_by_dtype.values())
    aten = sum(cost.flops_by_dtype.values())
    seconds = sum(f / PRODUCT_PEAK.get(dt, hw.PEAK_FLOPS_FP32) for dt, f in cost.product_flops_by_dtype.items())
    return seconds + (aten - products) / hw.PEAK_FLOPS_FP32 + sum(cost.kernel_seconds.values())


def _wire_bytes(kind: str, nbytes: float, group: float) -> float:
    """The bytes a card sends for one collective of ``nbytes`` (the full
    buffer) on a bidirectional ring of ``group`` cards (the reference's
    model)."""
    g = max(group, 2)
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * frac
    return nbytes  # collective-permute: point-to-point


def _collective_seconds(cost: Cost) -> float:
    """Ring-model seconds for the card's collective traffic: each
    collective at the link its group crosses."""
    return sum(_wire_bytes(e["kind"], e["bytes"], e["group"])
               / (hw.NVLINK_BW if e["link"] == "nvlink" else hw.IB_BW) for e in cost.collectives.values())


def roofline(*, cost: Cost, n_params: float, n_tokens: float, chips: int = 1,
             kind: str = "train") -> RooflineTerms:
    """Three-term roofline for one walked cell (per-card quantities in)."""
    compute_s = compute_seconds(cost)
    memory_s = cost.bytes / hw.HBM_BW
    collective_s = _collective_seconds(cost)
    # MODEL_FLOPS: 6*N*D for a train step (fwd+bwd), 2*N*D forward-only.
    mult = 6.0 if kind == "train" else 2.0
    model_flops = mult * n_params * n_tokens
    walked = cost.flops * chips
    useful = model_flops / walked if walked else 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bound = max(terms, key=terms.get)
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        memory_kernel_adj_s=memory_s,
        collective_s=collective_s,
        flops=cost.flops,
        bytes=cost.bytes,
        collective_bytes=cost.total_collective_bytes,
        model_flops=model_flops,
        useful_ratio=useful,
        bound=bound,
        detail={
            "compute_at_bf16_s": cost.flops / hw.PEAK_FLOPS_BF16,
            "flops_by_dtype": dict(cost.flops_by_dtype),
            "product_flops_by_dtype": dict(cost.product_flops_by_dtype),
            "kernel_flops": dict(cost.tagged_flops),
            "kernel_bytes": dict(cost.tagged_bytes),
            "kernel_seconds": dict(cost.kernel_seconds),
            "kernel_calls": dict(cost.kernel_calls),
            "per_collective_bytes": dict(cost.collective_bytes),
            "per_collective_ops": dict(cost.collective_ops),
            "group_sizes": dict(cost.group_sizes),
            "collectives": {k: dict(v) for k, v in cost.collectives.items()},
        },
    )


def roofline_fraction(t: RooflineTerms) -> float:
    """How close the dominant term says we are to the compute roofline.

    = useful compute time at the bf16 peak / max(all terms): 1.0 means the
    step runs at the card's model-flops peak; lower means redundant
    compute, compute on slower units, memory, or collectives dominate.
    """
    useful_s = t.detail["compute_at_bf16_s"] * max(t.useful_ratio, 0.0)
    m = max(t.compute_s, t.memory_kernel_adj_s, t.collective_s)
    return useful_s / m if m > 0 else 0.0


def format_row(name: str, t: RooflineTerms) -> str:
    return (
        f"{name:42s} comp={t.compute_s*1e3:9.3f}ms mem={t.memory_kernel_adj_s*1e3:9.3f}ms "
        f"(raw {t.memory_s*1e3:9.3f}ms) coll={t.collective_s*1e3:9.3f}ms bound={t.bound:10s} "
        f"useful={t.useful_ratio:6.3f} roofline={roofline_fraction(t):5.3f}"
    )
