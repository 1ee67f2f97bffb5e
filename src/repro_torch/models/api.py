"""Model API for the port (mirrors repro/models/api.py).

Every family of the reference is ported for serving: dense
(``transformer``), moe (``moe``), ssm (``rwkv6``), hybrid (``zamba2``),
vlm (``vlm``: embeds and M-RoPE positions in) and audio (``whisper``:
tokens and audio frames in), and so are the loss, its gradients and the
train step (``make_train_step``, AdamW) of every family: attention through
``common.AttentionFn`` and the scans through ``WKV6Fn`` and ``SSDFn``,
each a kernel forward on the card and a backward in plain PyTorch.

The shape-only entry points (``abstract_params``, ``abstract_cache``,
``input_specs``) build meta tensors, with nothing drawn or allocated, for
the cost walk of ``launch/dryrun.py``. The reference's sharding specs
(``param_specs``, ``cache_specs``, ``batch_specs``) are its trees of
partition specs (``launch.mesh``), pure data; the sharded engine's mesh
places parameters by ``launch.mesh.shard_model_params`` and the models
constrain at the reference's sites (``models.transformer``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import BATCH
from repro_torch.models import common, moe, rwkv6, transformer, vlm, whisper, zamba2
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_update_

_PORTED = {"dense": transformer, "moe": moe, "ssm": rwkv6, "hybrid": zamba2, "vlm": vlm,
           "audio": whisper}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig

    @property
    def family(self) -> str:
        return self.cfg.family

    def init(self, seed: int = 0, device=None) -> torch.nn.Module:
        """Random-init params from ``torch.Generator().manual_seed(seed)``,
        drawn on the CPU and placed on ``device`` (None -> the CUDA card).
        On ``meta`` nothing is drawn: the initializers get no generator and
        every leaf is made on meta, with the tree, names, shapes and dtypes
        of a drawn init."""
        dev = resolve_device(device)
        if dev.type == "meta":
            with torch.device(dev):
                return _PORTED[self.family].init(self.cfg, None, device=dev)
        gen = torch.Generator().manual_seed(int(seed))
        return _PORTED[self.family].init(self.cfg, gen, device=dev)

    def abstract_params(self) -> torch.nn.Module:
        """``init``'s parameter module on the meta device, nothing drawn."""
        return self.init(device="meta")

    def param_specs(self) -> dict:
        return _PORTED[self.family].param_specs(self.cfg)

    def cache_specs(self) -> dict:
        return _PORTED[self.family].cache_specs(self.cfg)

    def init_cache(self, batch: int, max_len: int, device=None, mesh=None) -> dict:
        """The family's cache; over a ``mesh``, this rank's: every leaf whose
        ``cache_specs`` put its heads over ``MODEL`` (the KV and cross
        caches, rwkv6's wkv state, the Mamba2 SSM state) holds this rank's
        share of them where the model axis divides them, all of them where
        it does not (``launch.mesh.local_size``), as the models compute
        them; the rest (shifts, conv tails, lengths) whole. Under
        ``sp_activations`` attention gathers K/V whole on every rank, and
        the cache holds every head. Every leaf starts at zero."""
        mod, dev = _PORTED[self.family], resolve_device(device)
        if mesh is None or self.cfg.sp_activations:
            return mod.init_cache(self.cfg, batch, max_len, device=dev)
        # model_axis 1: the KV specs take their heads form, so every MODEL
        # entry marks a heads axis (the port never splits the sequence)
        specs = mod.cache_specs(self.cfg, 1)
        out = {}
        for name, leaf in mod.init_cache(self.cfg, batch, max_len, device="meta").items():
            shape = [meshlib.local_size(n, mesh) if a == meshlib.MODEL else n
                     for n, a in zip(leaf.shape, specs[name])]
            out[name] = torch.zeros(shape, dtype=leaf.dtype, device=dev)
        return out

    def abstract_cache(self, batch: int, max_len: int) -> dict:
        """``init_cache``'s tree on the meta device, nothing allocated."""
        return self.init_cache(batch, max_len, device="meta")

    def input_specs(self, shape_name) -> dict:
        """Meta tensors for the step of a ``SHAPES`` cell (its name, or a
        ``ShapeSpec`` of its own) (global shapes,
        nothing allocated), under the reference's keys and dtypes: int32
        tokens, labels and M-RoPE positions, bf16 embeds and frames. A
        train or prefill cell gets the family's inputs (and a train cell
        its labels); a decode cell one new token a row against a cache of
        ``seq_len`` positions (``abstract_cache``)."""
        cfg, sh = self.cfg, SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
        b, s = sh.global_batch, sh.seq_len
        tok = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
        emb = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="meta")
        if sh.kind in ("train", "prefill"):
            if self.family == "vlm":
                batch = {"embeds": emb(b, s, cfg.d_model), "mrope_positions": tok(3, b, s)}
            elif self.family == "audio":
                batch = {"tokens": tok(b, s), "frames": emb(b, cfg.n_audio_frames, cfg.d_model)}
            else:
                batch = {"tokens": tok(b, s)}
            if sh.kind == "train":
                batch["labels"] = tok(b, s)
            return batch
        return {"tokens": tok(b, 1), "cache": self.abstract_cache(b, s)}

    def batch_specs(self, shape_name) -> dict:
        """Partition specs matching ``input_specs(shape_name)``."""
        sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
        specs = {}
        if sh.kind in ("train", "prefill"):
            if self.family == "vlm":
                specs["embeds"] = (BATCH, None, None)
                specs["mrope_positions"] = (None, BATCH, None)
            elif self.family == "audio":
                specs["tokens"] = (BATCH, None)
                specs["frames"] = (BATCH, None, None)
            else:
                specs["tokens"] = (BATCH, None)
            if sh.kind == "train":
                specs["labels"] = (BATCH, None)
            return specs
        return {"tokens": (BATCH, None), "cache": self.cache_specs()}

    def loss(self, params, batch: dict, *, remat: Optional[bool] = None):
        """Trunk + fused sequence-chunked head and CE (+ the moe aux loss):
        (loss, metrics), every value an f32 tensor, differentiable w.r.t.
        the parameters that require grad. The full (B, S, Vp) logits are
        never materialized (``common.fused_ce_loss``). The batch keys are
        the reference's: ``tokens`` (and ``frames`` for audio, ``embeds``
        and ``mrope_positions`` for vlm) and ``labels``."""
        cfg = self.cfg
        ce = functools.partial(common.fused_ce_loss, labels=batch["labels"], vocab_size=cfg.vocab_size)
        if self.family == "dense":
            return ce(*transformer.features(params, cfg, batch["tokens"], remat=remat))
        if self.family == "moe":
            h, w, aux = moe.features(params, cfg, batch["tokens"], remat=remat)
            loss, metrics = ce(h, w)
            metrics["aux_loss"] = aux
            return loss + meshlib.like(aux, loss), metrics  # aux: plain, the same on every rank
        if self.family == "vlm":
            return ce(*vlm.features(params, cfg, batch["embeds"], batch["mrope_positions"], remat=remat))
        if self.family == "audio":
            return ce(*whisper.features(params, cfg, batch["tokens"], batch["frames"], remat=remat))
        return ce(*_PORTED[self.family].features(params, cfg, batch["tokens"], remat=remat))

    def prefill(self, params, batch: dict, *, max_len: int):
        """The reference's batch keys: ``embeds`` and ``mrope_positions`` for
        vlm, ``tokens`` and ``frames`` for audio, ``tokens`` otherwise."""
        mod, cfg = _PORTED[self.family], self.cfg
        if self.family == "vlm":
            return mod.prefill(params, cfg, batch["embeds"], batch["mrope_positions"], max_len=max_len)
        if self.family == "audio":
            return mod.prefill(params, cfg, batch["tokens"], batch["frames"], max_len=max_len)
        return mod.prefill(params, cfg, batch["tokens"], max_len=max_len)

    def decode(self, params, cache: dict, tokens, *, page_size: int = 16, active=None):
        """One decode step, the cache updated in place; a given (B,) bool
        ``active`` leaves every cache leaf of its False rows as it was.
        The cache is ``init_cache``'s: plain tensors, across a mesh this
        rank's heads, and its rows where ``tokens`` are split over the data
        axes."""
        return _PORTED[self.family].decode_step(params, self.cfg, cache, tokens,
                                                page_size=page_size, active=active)


def get_model(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(cfg)


def card_widths(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` at widths the card's kernels take: attention head_dim 64 (the
    flash and paged kernels take 64 or 128), d_model widened to 64 per head
    and vlm's M-RoPE sections with it. A reduced config (head_dim 16) needs
    this on the card; the scans' head sizes of 16 are built as they are, so
    an ssm config and a config already at 64 or 128 come back unchanged."""
    hd = cfg.head_dim
    if cfg.family == "ssm" or hd in (64, 128):
        return cfg
    if 64 % hd:
        raise ValueError(f"head_dim {hd} does not widen to 64")
    return dataclasses.replace(cfg, d_model=64 * cfg.n_heads,
                               mrope_sections=tuple(s * (64 // hd) for s in cfg.mrope_sections))


def kernel_launches(cfg: ModelConfig, prefills: int, decodes: int) -> dict:
    """The model kernels' launches on the card over ``prefills`` prefill and
    ``decodes`` decode dispatches: attention once per dense, moe or vlm layer
    or per application of zamba2's shared block (flash in prefill, paged in
    decode), and a scan once per recurrent layer in either. The moe family
    launches as the dense one (its experts are plain products), and so does
    vlm (the dense backbone). Whisper's prefill runs flash in every encoder
    layer and twice in every decoder layer (self- and cross-attention), its
    decode paged (self) and flash (cross) once a decoder layer."""
    n = cfg.n_layers
    if cfg.family in ("dense", "moe", "vlm"):
        return {"flash_attention": n * prefills, "paged_attention": n * decodes, "wkv6": 0, "ssd": 0}
    if cfg.family == "audio":
        return {"flash_attention": (cfg.n_encoder_layers + 2 * n) * prefills + n * decodes,
                "paged_attention": n * decodes, "wkv6": 0, "ssd": 0}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "paged_attention": 0, "wkv6": n * (prefills + decodes), "ssd": 0}
    apps = zamba2.n_attn_apps(cfg)
    return {"flash_attention": apps * prefills, "paged_attention": apps * decodes, "wkv6": 0,
            "ssd": n * (prefills + decodes)}


def train_kernel_launches(cfg: ModelConfig, micro_batches: int, remat: Optional[bool] = None) -> dict:
    """The model kernels' launches on the card over one train step of
    ``micro_batches`` micro-batches (the loss and its gradients). Each
    forward of an attention layer launches flash (B5) once, of an rwkv6
    layer the WKV6 scan (B6), of a Mamba2 layer the SSD scan (B7); the
    backwards are plain PyTorch and launch none. With remat (default
    ``cfg.remat``) a checkpointed layer's forward runs again in the
    backward: once more a dense, moe, vlm or rwkv6 layer and a whisper
    decoder layer (self- and cross-attention; its encoder is not
    checkpointed); zamba2 nests a checkpoint per Mamba2 layer inside one a
    group, so a grouped Mamba2 layer runs three times, a tail layer twice
    and each application of the shared block twice."""
    runs = 2 if (cfg.remat if remat is None else remat) else 1
    n = {"flash_attention": 0, "paged_attention": 0, "wkv6": 0, "ssd": 0}
    if cfg.family in ("dense", "moe", "vlm"):
        n["flash_attention"] = runs * cfg.n_layers
    elif cfg.family == "audio":
        n["flash_attention"] = cfg.n_encoder_layers + 2 * runs * cfg.n_layers
    elif cfg.family == "ssm":
        n["wkv6"] = runs * cfg.n_layers
    else:
        apps = zamba2.n_attn_apps(cfg)
        grouped = apps * cfg.shared_attn_every
        n["flash_attention"] = runs * apps
        n["ssd"] = (2 * runs - 1) * grouped + runs * (cfg.n_layers - grouped)
    return {k: v * micro_batches for k, v in n.items()}


def trainable(params: torch.nn.Module) -> dict:
    """The float parameters a train step updates, by ``state_dict`` name."""
    return {n: p for n, p in params.named_parameters() if p.is_floating_point()}


def _split(name: str, x: torch.Tensor, ga: int) -> torch.Tensor:
    """A batch leaf as ``ga`` micro-batches on a new leading axis; vlm's
    (3, B, S) ``mrope_positions`` split on their batch axis 1."""
    axis = 1 if name == "mrope_positions" else 0
    b = x.shape[axis]
    if b % ga:
        raise ValueError(f"batch {name}: {b} rows do not split into {ga} micro-batches")
    x = x.reshape(*x.shape[:axis], ga, b // ga, *x.shape[axis + 1:])
    return x.movedim(axis, 0)


def _on_mesh(name: str, x: torch.Tensor, mesh) -> torch.Tensor:
    """A micro-batch leaf as a DTensor sharded on its batch axis over
    ``BATCH`` (each rank keeps its rows), the counterpart of the
    reference's ``shard(x, None, BATCH)``; plain with no mesh."""
    if mesh is None:
        return x
    axes = (None, BATCH) if name == "mrope_positions" else (BATCH,)
    return meshlib.distribute(x, mesh, axes + (None,) * (x.ndim - len(axes)))


def _micro_batches(batch: dict, ga: int, mesh) -> list:
    """The global batch (a DTensor gathered whole first) as ``ga``
    micro-batches, as the reference's: micro-batch i holds rows i * B / ga
    onwards, each leaf on its batch axis (axis 1 for vlm's
    ``mrope_positions``) split over ``BATCH`` across a mesh."""
    micro = {k: _split(k, meshlib.whole(v), ga) for k, v in batch.items()}
    return [{k: _on_mesh(k, v[i], mesh) for k, v in micro.items()} for i in range(ga)]


def _storage_placements(named: dict, storage_specs: Optional[dict], mesh) -> dict:
    """Each trainable leaf's placements: its own, which ``storage_specs``
    (when given) must name."""
    out = {}
    for n, p in named.items():
        out[n] = list(p.placements) if meshlib.is_dtensor(p) else None
        if storage_specs is not None and mesh is not None:
            want = meshlib.placements(mesh, meshlib.leaf_spec(storage_specs, n), p.shape)
            if out[n] != want:
                raise ValueError(f"{n} is placed {out[n]}, its storage spec says {want}: "
                                 "place the parameters at storage_specs (launch.mesh.place_params)")
    return out


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, *, compute_specs: Optional[dict] = None,
                    grad_accum: Optional[int] = None, storage_specs: Optional[dict] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the model (an ``nn.Module``), ``opt_state`` the
    ``optim.adamw_init`` of ``trainable(params)``, ``batch`` the loss's
    batch (``labels`` and the family's inputs). The step switches
    ``requires_grad`` on for the trainable leaves, takes the loss and its
    gradients, switches it off again (so a serving path never sees a leaf
    that requires grad), and writes AdamW's new values into the leaves and
    ``opt_state``'s moments in place, a leaf at a time
    (``optim.adamw.adamw_update_``): the held casts see the new version and
    cast anew. Every metric is a 0-d f32 tensor on the model's device; the
    step reads nothing back to the host.

    ``grad_accum`` (default ``cfg.grad_accum``): the batch split into that
    many micro-batches, run one after another; their gradients summed in
    f32 and, like their metrics, divided by the count.

    Across a mesh of cards (weight pooling, the reference's
    ``compute_specs``/``storage_specs``), for every family: the parameters
    arrive as DTensors placed at their storage layout
    (``launch.mesh.place_params`` at ``core.pooling.pooled_specs``), and
    AdamW's moments beside them (``adamw_init`` keeps each leaf's
    placement). The step runs under their mesh: the models gather each
    layer's leaves to the compute layout (``api.param_specs()``, which
    ``compute_specs`` must be) where the layer runs, cast first, one layer
    at a time (``common.cast``), and nothing gathered is held across steps;
    attention (B5) and the scans (B6, B7) run on each rank's rows and
    heads. ``batch`` is the global batch, the same on every rank (a DTensor
    is gathered first, ``_micro_batches``); each micro-batch enters as a
    DTensor sharded on its batch axis over ``BATCH``, so autograd sums
    the data-parallel ranks' gradients: the gradient of a gather comes back
    partial over the batch axes, and placing it at the storage layout is
    the reduce-scatter. A leaf used at
    several sites (zamba2's shared block, a tied head) sums its gradients
    over them first. Gradients, the f32 accumulators of ``grad_accum`` and
    the update stay at the storage layout (``storage_specs``, when given,
    must be it); the metrics are the same plain tensors on every rank.
    With every leaf plain the specs change nothing.
    """
    if compute_specs is not None and compute_specs != api.param_specs():
        raise ValueError("the models gather at their own sites: compute_specs must be api.param_specs()")
    ga = grad_accum if grad_accum is not None else api.cfg.grad_accum

    def grads_of(params, named: dict, batch: dict):
        loss, metrics = api.loss(params, batch)
        g = torch.autograd.grad(meshlib.reduced(loss), list(named.values()), allow_unused=True,
                                materialize_grads=True)
        return dict(zip(named, g)), metrics

    def train_step(params, opt_state, batch):
        named = trainable(params)
        mesh = meshlib.mesh_of(named.values())
        place = _storage_placements(named, storage_specs, mesh)
        for p in named.values():
            p.requires_grad_(True)
        try:
            with meshlib.activate(mesh):
                grads, metrics = {}, {}
                for mb in _micro_batches(batch, ga, mesh):
                    g, m = grads_of(params, named, mb)
                    # the storage layout: a partial sum over the batch axes is
                    # reduce-scattered (or all-reduced) into it
                    g = {n: x if place[n] is None else x.redistribute(x.device_mesh, place[n])
                         for n, x in g.items()}
                    for total, part in ((grads, g), (metrics, m)):
                        for k, x in part.items():
                            x = x.detach().float()
                            total[k] = total[k] + x if k in total else x
                # one micro-batch divides by 1, which changes no bit
                grads = {n: x / ga for n, x in grads.items()}
                metrics = {k: meshlib.whole(meshlib.reduced(x / ga)) for k, x in metrics.items()}
        finally:
            for p in named.values():
                p.requires_grad_(False)
        # in place, a leaf at a time: a card has no room for a second state
        opt_state, om = adamw_update_(opt_cfg, {n: p.detach() for n, p in named.items()}, grads, opt_state)
        om = {k: meshlib.whole(meshlib.reduced(x)) for k, x in om.items()}
        return params, opt_state, {**metrics, **om}

    return train_step


def make_prefill_step(api: ModelAPI, max_len: int):
    """(params, batch) -> (next_token_logits (B, Vp), cache)."""

    def prefill_step(params, batch):
        logits, cache = api.prefill(params, batch, max_len=max_len)
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(api: ModelAPI, *, vocab: Optional[int] = None, page_size: int = 16):
    """(params, cache, tokens (B,1), active=None) -> (greedy next_tokens (B,1)
    int32, cache').

    ``vocab`` restricts the argmax to the first ``vocab`` logits: the head
    is padded, and a serving caller must never sample a padding id.
    ``page_size`` is the page the card's decode kernel walks a KV cache in
    (the recurrent state of the ssm family has none and ignores it).
    ``active`` gates the cache update per row (``ModelAPI.decode``).
    """

    def serve_step(params, cache, tokens, active=None):
        logits, cache = api.decode(params, cache, tokens, page_size=page_size, active=active)
        logits = meshlib.whole(logits)  # vocabulary-sharded across a mesh
        v = logits.shape[-1] if vocab is None else vocab
        nxt = torch.argmax(logits[:, -1, :v], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step
