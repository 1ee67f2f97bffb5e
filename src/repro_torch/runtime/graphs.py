"""One engine dispatch captured as a CUDA graph and replayed on the card.

The reference runs each serving dispatch as one jitted executable (the
fused decode, and the chunk step's ``lax.scan`` over token columns,
``repro/runtime/serving.py:366-411``). PyTorch runs eagerly, one host
launch per kernel: some 2,800-5,300 a full-width decode. The counterpart
of one executable here is a captured ``torch.cuda.CUDAGraph``, whose
replay launches them all from one host call.

A dispatch is a function ``fn(buffers)`` over a fixed nest of tensors
(dicts of tensors): it reads its inputs from them and writes its results
back into them in place, so the graph's addresses stay the engine's own.
:class:`StepGraph` warms ``fn`` up on a copy of the buffers (never on the
buffers, which a warm-up would advance), first on the current stream, so
lazily made state such as the models' held weight casts
(``models.common.cast``) is made there, then on the side stream it
captures on, as ``torch.cuda.graph`` expects. It captures with
``capture_error_mode="global"``, so a call that may not run under capture
(a host read, a synchronize) raises; a failed capture raises and nothing
falls back to running eagerly.

The kernel wrappers' ``LAUNCHES`` are Python increments, so they count a
capture once and none of its replays. A graph records the launches it
holds (the counts' growth over its capture) and its replays; what its
replays launched is their product (:meth:`StepGraph.replayed`).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.kernels import launch_counts


def _clone(tree):
    """A copy of a nest of dicts of tensors, every tensor cloned."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class StepGraph:
    """``fn(buffers)`` captured once on the buffers' CUDA device.

    ``pool`` is another graph's memory pool to share: the engine's graphs
    replay one at a time on one stream and keep no output in the pool, so
    one pool serves them all.
    """

    def __init__(self, fn: Callable[[dict], None], buffers: dict, pool=None):
        stream = torch.cuda.current_stream()
        fn(_clone(buffers))
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(_clone(buffers))
        stream.wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side, capture_error_mode="global"):
            fn(buffers)
        after = launch_counts()
        self.launches: Dict[str, int] = {k: after[k] - before[k] for k in after}
        self.replays = 0

    def pool(self):
        return self.graph.pool()

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def replayed(self) -> Dict[str, int]:
        """Kernel launches made by this graph's replays so far."""
        return {k: n * self.replays for k, n in self.launches.items()}

