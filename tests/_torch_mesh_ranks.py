"""Rank-side bodies of the port's mesh tests (no JAX here: a rank imports
only the port). ``spawn`` starts ``world`` processes that meet at a
``file://`` store (``gloo`` on the CPU, ``nccl`` over cards), runs
``fn(rank, world, *args)`` in each and returns their results by rank; a
rank that raises fails the call with its traceback. At the end, the
checks of one engine case against the reference's run, shared by the
files that hold the mesh engine to it."""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import multiprocessing as mp
import queue
import traceback

import numpy as np
import torch

ENGINE = dict(max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
              device_tiering=True, tiered_identity_scales=True, tiered_verify=True)
N_REQUESTS = 6
PROMPT = np.arange(1, 20, dtype=np.int32) * 7 % 500  # the logits probe's prompt


def _child(fn, rank, world, store, backend, out, args):
    try:
        torch.set_num_threads(1)
        # DTensor warns at every reduction over two or three mesh axes
        logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
        from repro_torch.launch import mesh as meshlib

        meshlib.init_process_group(rank=rank, world_size=world, store=store, backend=backend)
        try:
            out.put((rank, fn(rank, world, *args)))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent raises it
        out.put((rank, {"error": traceback.format_exc()}))


def spawn(fn, world: int, store: str, *args, backend: str = "gloo", timeout: float = 300.0) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, backend, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, res = out.get(timeout=timeout)
            results[rank] = res
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    errors = [r["error"] for r in results.values() if isinstance(r, dict) and "error" in r]
    assert not errors, errors[0]
    assert sorted(results) == list(range(world)), f"ranks {sorted(results)} of {world} answered"
    return [results[r] for r in range(world)]


@contextlib.contextmanager
def one_rank_mesh(store: str, shape=(1, 1, 1), names=("data", "pool", "model")):
    """A ``gloo`` process group of this process alone and a mesh of
    ``shape`` (one rank) over it, for the tests of an entry point on a
    1-rank mesh; the group is destroyed on the way out."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import mesh as meshlib

    meshlib.init_process_group(rank=0, world_size=1, store=store, backend="gloo")
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the mesh layer


def mesh_checks(rank: int, world: int) -> dict:
    """The reference's ``tests/test_sharding.py`` semantics, rank side."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import common
    from repro_torch.models.api import get_model

    res = {}
    for model in (0, 3, 2 * world):
        try:
            meshlib.make_host_mesh(model=model)
            res[f"host_{model}"] = "built"
        except ValueError as e:
            res[f"host_{model}"] = str(e)
    for model in (0, world + 1):
        try:
            meshlib.make_serving_mesh(model=model)
            res[f"serving_{model}"] = "built"
        except ValueError as e:
            res[f"serving_{model}"] = str(e)
    host = meshlib.make_host_mesh(model=1)
    res["host_shape"] = tuple(host.shape)
    with meshlib.activate(host):
        res["spec"] = meshlib.spec(("pod", "data"), "model", None)
        res["named"] = meshlib.named(host, "model", ("pod", "data")).spec
        res["tree"] = meshlib.tree_shardings(host, {"a": ("model", None), "b": {"c": (None,)}})["b"]["c"].spec
    meshes = {n: meshlib.make_serving_mesh(n) for n in (1, 2, world)}
    full = meshes[world]
    res["serving_shape"] = {n: tuple(m.shape) for n, m in meshes.items()}
    # shard(): the identity with no active mesh and on a plain tensor; the
    # divisibility drop under one
    x = DTensor.from_local(torch.arange(15.0).reshape(3, 5), full, [Replicate()], run_check=False)
    res["noop_without_mesh"] = meshlib.shard(x, None, "model") is x
    with meshlib.activate(full):
        plain = torch.ones(3, 8)
        res["noop_on_plain"] = meshlib.shard(plain, "data", "model") is plain
        res["drop"] = [repr(p) for p in meshlib.shard(x, "model", "model").placements]  # 3, 5 % 4
        y = DTensor.from_local(torch.arange(24.0).reshape(3, 8), full, [Replicate()], run_check=False)
        ys = meshlib.shard(y, ("pod", "data"), "model")
        res["kept"] = ([repr(p) for p in ys.placements], tuple(ys.to_local().shape),
                       torch.equal(ys.full_tensor(), y.full_tensor()))
        # rms_norm of a residual sharded along D equals the plain one's
        h = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(0))
        w = torch.linspace(0.5, 1.5, 16)
        hs = DTensor.from_local(h.chunk(world, -1)[rank].clone(), full, [Shard(2)], run_check=False)
        res["rms_sharded"] = float((meshlib.whole(common.rms_norm(hs, meshlib.like(w, hs)))
                                    - common.rms_norm(h, w)).abs().max())
        # matmul_f32: a plain activation against a column-sharded weight,
        # then against a row-sharded one (partial sums added across ranks)
        g = torch.Generator().manual_seed(1)  # the same on every rank
        a, b = torch.randn(2, 16, generator=g), torch.randn(16, 8, generator=g)
        bc = DTensor.from_local(b.chunk(world, -1)[rank].clone(), full, [Shard(1)], run_check=False)
        br = DTensor.from_local(b.chunk(world, 0)[rank].clone(), full, [Shard(0)], run_check=False)
        ac = DTensor.from_local(a.chunk(world, -1)[rank].clone(), full, [Shard(1)], run_check=False)
        res["matmul_col"] = float((meshlib.whole(common.matmul_f32(a, bc)) - a @ b).abs().max())
        prod = common.matmul_f32(ac, br)
        res["matmul_row"] = ([repr(p) for p in prod.placements],
                             float((meshlib.whole(prod) - a @ b).abs().max()))
    res["local_caches"] = _local_caches(meshes)
    res["payload"] = _payload_widths(meshes)
    res["scans"] = _scans_on_local_heads(full)
    if meshlib.in_mesh(meshes[1]):
        res["one_rank_ops"] = _one_rank_ops(meshes[1])
    # attention on local heads: qwen2.5-3b's 16 query heads over 2 KV heads
    # on 4 ranks (4 query heads a rank, the KV heads replicated): each rank
    # must read only the KV head its queries group over
    res["gqa"] = _gqa_over_ranks(full, world)
    # shard_model_params: local shapes on every rank of every mesh, and the
    # 1-device placement bit-identical
    tree = common.ParamTree(w=torch.arange(12.0).reshape(3, 4), b=torch.arange(5.0), odd=torch.ones(3),
                            sub=common.ParamTree(m=torch.randn(6, 8, generator=torch.Generator().manual_seed(2))))
    api = get_model(dataclasses.replace(get_config("qwen2.5-3b").reduced(), sp_activations=False))
    model = api.init(0, device="cpu")
    res["placed"] = {}
    for n, m in meshes.items():
        if not meshlib.in_mesh(m):
            continue
        for label, src in (("tree", tree), ("model", model)):
            placed = meshlib.shard_model_params(src, m)
            res["placed"][(n, label)] = {
                name: (tuple(p.to_local().shape), [repr(q) for q in p.placements], p.device.type,
                       torch.equal(p.full_tensor(), dict(src.named_parameters())[name]))
                for name, p in placed.named_parameters()}
            if n == 1:
                res["identical"] = all(torch.equal(p.to_local(), dict(src.named_parameters())[name])
                                       for name, p in placed.named_parameters())
        # the held casts of a placed layer: placed at its compute specs, keyed
        # on the local storage
        with meshlib.activate(m):
            from repro_torch.models import transformer

            placed = meshlib.shard_model_params(model, m)
            layer = placed.layers[0].tree(torch.bfloat16, transformer.layer_specs(api.cfg))
            again = placed.layers[0].tree(torch.bfloat16, transformer.layer_specs(api.cfg))
            res.setdefault("casts", {})[n] = (
                {k: [repr(q) for q in v.placements] for k, v in layer["attn"].items()},
                all(again["attn"][k] is v for k, v in layer["attn"].items()),
                layer["mlp"]["w_down"].dtype == torch.bfloat16)
    return res


FAMILY_ARCHS = ("qwen2.5-3b", "granite-moe-3b-a800m", "qwen2-vl-7b", "rwkv6-7b", "zamba2-1.2b", "whisper-base")


def _local_caches(meshes) -> dict:
    """``init_cache(mesh=)``'s leaf shapes, one arch a family, over each mesh
    this rank is in (and with no mesh)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model

    out = {}
    for arch in FAMILY_ARCHS:
        api = get_model(get_config(arch).reduced())
        for n, mesh in [(0, None)] + sorted(meshes.items()):
            if mesh is None or meshlib.in_mesh(mesh):
                out[(arch, n)] = {k: tuple(v.shape) for k, v in api.init_cache(4, 64, device="cpu", mesh=mesh).items()}
    return out


def _payload_widths(meshes) -> dict:
    """The tier store's row width of reduced zamba2's engine (2 layers, one
    application of the shared block) unsharded and over each mesh this
    rank is in."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serving import EngineConfig, ServingEngine
    from repro_torch.runtime.sharded import ShardedServingEngine

    api = get_model(get_config("zamba2-1.2b").reduced())
    model = api.init(0, device="cpu")
    out = {0: ServingEngine(api, model, EngineConfig(**ENGINE), device="cpu").tiered.row_dim}
    for n, mesh in sorted(meshes.items()):
        if meshlib.in_mesh(mesh):
            eng = ShardedServingEngine(api, model, EngineConfig(**ENGINE, model_shards=n), mesh=mesh)
            out[n] = (eng.tiered.row_dim, tuple(eng.cache["k"].shape))
    return out


def _scans_on_local_heads(mesh) -> dict:
    """B6 (``wkv6_chunked``) and B7 (``ssd_chunked``) on this rank's heads
    (``launch.mesh.local_heads``) against the same heads' slice of the
    whole-head call, from a given state: the largest differences of the
    outputs and the states, and the local head counts."""
    from repro_torch.kernels.mamba2_scan import ssd_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked
    from repro_torch.launch import mesh as meshlib

    g = torch.Generator().manual_seed(4)  # the same on every rank
    b, t, h, hd, n = 2, 24, 8, 16, 16
    r, k, v = (torch.randn(b, t, h, hd, generator=g) * 0.5 for _ in range(3))
    lw = -torch.rand(b, t, h, hd, generator=g) - 0.1
    u, s0 = torch.randn(h, hd, generator=g), torch.randn(b, h, hd, hd, generator=g) * 0.1
    x, dt = torch.randn(b, t, h, hd, generator=g), torch.rand(b, t, h, generator=g) * 0.2
    a, d = -torch.rand(h, generator=g) - 0.5, torch.randn(h, generator=g)
    bb, cc = torch.randn(b, t, n, generator=g), torch.randn(b, t, n, generator=g)
    s1 = torch.randn(b, h, hd, n, generator=g) * 0.1
    y6, f6 = wkv6_chunked(r, k, v, lw, u, s0.clone())
    y7, f7 = ssd_chunked(x, dt, a, bb, cc, d, s1.clone())
    with meshlib.activate(mesh):
        heads = meshlib.local_heads
        ly6, lf6 = wkv6_chunked(heads(r, 2), heads(k, 2), heads(v, 2), heads(lw, 2), heads(u, 0), heads(s0, 1).clone())
        ly7, lf7 = ssd_chunked(heads(x, 2), heads(dt, 2), heads(a, 0), bb, cc, heads(d, 0), heads(s1, 1).clone())
        err = lambda local, whole, dim: float((local - heads(whole, dim)).abs().max())
        return {"wkv6": (ly6.shape[2], err(ly6, y6, 2), err(lf6, f6, 1)),
                "ssd": (ly7.shape[2], err(ly7, y7, 2), err(lf7, f7, 1))}


# the ops whose order of summation decides their bits (on the card a GEMM's
# kernel is picked by its shapes and strides)
SUMMING_OPS = ("mm", "bmm", "addmm", "baddbmm", "var", "mean", "sum", "softmax", "cumsum", "sort")


def _one_rank_ops(mesh) -> dict:
    """Each family's prefill and decode at bf16 compute, with every leaf
    plain and then placed on the 1-rank ``mesh``: the summing ops each
    runs (op, and each tensor argument's shape, stride and dtype), and
    whether the logits are bit-equal. The card's 1-card mesh is held
    bit-equal to the engine without one, which needs the same kernels on
    the same layouts."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__.lstrip("_")
            if name in SUMMING_OPS:
                self.seen.append((name, tuple((tuple(a.shape), a.stride(), str(a.dtype))
                                              for a in args if isinstance(a, torch.Tensor))))
            return func(*args, **(kwargs or {}))

    toks = torch.arange(1, 13, dtype=torch.int32)[None].repeat(2, 1)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="bfloat16", sp_activations=False)
        api = get_model(cfg)
        plain = api.init(0, device="cpu")
        runs = []
        for params, on in ((plain, None), (meshlib.shard_model_params(plain, mesh), mesh)):
            with torch.no_grad(), meshlib.activate(on):
                batch = {"tokens": toks}
                if cfg.family == "vlm":
                    batch = {"embeds": meshlib.take_rows(params.embed, toks),
                             "mrope_positions": torch.arange(12, dtype=torch.int32).expand(3, 2, 12)}
                elif cfg.family == "audio":
                    batch["frames"] = torch.zeros(2, cfg.n_audio_frames, cfg.d_model, dtype=torch.bfloat16)
                with Ops() as pre:
                    logits, cache = api.prefill(params, batch, max_len=16)
                with Ops() as dec:
                    nxt, _ = api.decode(params, cache, toks[:, :1], page_size=16)
            runs.append((pre.seen, dec.seen, meshlib.whole(logits), meshlib.whole(nxt)))
        (p0, d0, l0, n0), (p1, d1, l1, n1) = runs
        out[arch] = {"prefill_ops": p0 == p1 and len(p0) > 0, "decode_ops": d0 == d1 and len(d0) > 0,
                     "logits": torch.equal(l0, l1) and torch.equal(n0, n1)}
    return out


def _gqa_over_ranks(mesh, world: int) -> dict:
    """One attention layer of 16 query heads over 2 KV heads (head_dim 4),
    prefill and a decode, placed over ``mesh`` against the same layer on
    one device: the largest difference of the outputs and the caches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import attention, transformer

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_heads=16, n_kv_heads=2, d_model=64,
                              sp_activations=False)
    g = torch.Generator().manual_seed(3)
    layer = transformer.init_attn(cfg, g, torch.float32)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)  # nonzero biases too
    x = torch.randn(2, 6, 64, generator=g)
    pos = torch.arange(6)[None].expand(2, 6)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    x1 = torch.randn(2, 1, 64, generator=g)
    want, (k, v) = attention.apply_prefill(layer.tree(), cfg, x, pos, 8)
    kc, vc = k.clone(), v.clone()
    want_dec = attention.apply_decode(layer.tree(), cfg, x1, kc, vc, lengths)
    placed = meshlib.shard_model_params(layer, mesh)
    with meshlib.activate(mesh):
        p = placed.tree(None, attention.param_specs(cfg))
        got, (kl, vl) = attention.apply_prefill(p, cfg, meshlib.like(x, p["wq"]), pos, 8)
        kcl, vcl = kl.clone(), vl.clone()
        got_dec = attention.apply_decode(p, cfg, meshlib.like(x1, p["wq"]), kcl, vcl, lengths)
    return {"prefill": float((meshlib.whole(got) - want).abs().max()),
            "decode": float((meshlib.whole(got_dec) - want_dec).abs().max()),
            "cache": float((kcl - kc).abs().max()), "kv_heads": kl.shape[1]}


# ---------------------------------------------------------------------------
# the mesh engine


def _requests(cfg):
    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator

    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8, prefix_share=0.5,
                               n_prefixes=2)
    gen = RequestGenerator(prof, vocab_size=cfg.vocab_size, seed=0)
    return [next(gen) for _ in range(N_REQUESTS)]


def _watch(eng, steps: list):
    """Per step: the non-empty shards of its lookup, and this rank's launches."""
    store = eng.tiered
    orig = store.lookup_segments

    def lookup(ids, *a, **k):
        before = store.local.dispatches
        out = orig(ids, *a, **k)
        ids = np.asarray(ids, np.int64)
        steps.append((int(np.unique(ids % store.n_shards).size), store.local.dispatches - before))
        return out

    store.lookup_segments = lookup
    merged = {"near": 0, "far": 0, "slot": 0, "tenant": 0, "role": 0}
    drain = store.drain_counters

    def counted(discard=False):
        d = drain(discard=discard)
        for k in merged:
            merged[k] = merged[k] + np.asarray(d[k], np.int64) if k in ("slot", "tenant", "role") \
                else merged[k] + d[k]
        return d

    store.drain_counters = counted
    return merged


def cases_of(archs, world: int, chunked=()) -> list:
    """(arch, N, prefill_chunk) cases: every arch over ``world`` ranks and
    over 2, whole-slot; each of ``chunked`` also over 2 with chunks of 8."""
    return [(arch, n, 0) for arch in archs for n in (2, world)] + [(arch, 2, 8) for arch in chunked]


def case_id(arch: str, n: int, chunk: int) -> str:
    """A case's test id: ``arch-N``, and ``-chunkC`` on the chunked path."""
    return f"{arch}-{n}" + (f"-chunk{chunk}" if chunk else "")


def engine_run(rank: int, world: int, params: dict, card: bool = False, cases=None) -> dict:
    """The mesh engine of each (arch, N, prefill_chunk) case of ``cases``
    (default: every arch over all ``world`` ranks, then over ranks 0 and 1,
    whole-slot; ``ARCH:sp`` is ARCH with ``sp_activations`` on, every
    other arch serves with it off): tokens a step, books, merged drained planes, B1 a step,
    the local shapes of the placed leaves and of the cache, and one
    prefill's logits under the mesh, its input in the family's keys
    (``_prefill_batch``). ``params``: arch -> the reference's parameters as
    a state dict, or None for the port's seed-0 init. ``card``: the config
    at the card's attention widths (``card_widths``), each rank on its
    card. Results are keyed by case."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import card_widths, get_model
    from repro_torch.runtime.serving import EngineConfig
    from repro_torch.runtime.sharded import ShardedServingEngine

    cases = cases_of(params, world) if cases is None else cases
    # making a sub-mesh is collective: every rank makes each, in one order
    meshes = {n: meshlib.make_serving_mesh(n) for n in sorted({n for _, n, _ in cases})}
    out = {}
    for arch, state in params.items():
        base, _, flag = arch.partition(":")  # "ARCH:sp" keeps sp_activations on
        cfg = dataclasses.replace(get_config(base).reduced(), sp_activations=flag == "sp")
        if card:
            cfg = card_widths(cfg)
        api = get_model(cfg)
        model = api.init(0, device="cpu")
        if state is not None:
            model.load_state_dict(state, strict=True)
        for _, n, chunk in [c for c in cases if c[0] == arch]:
            mesh = meshes[n]
            if not meshlib.in_mesh(mesh):
                continue
            eng = ShardedServingEngine(api, model, EngineConfig(**ENGINE, model_shards=n, prefill_chunk=chunk),
                                       seed=0, mesh=mesh)
            steps = []
            merged = _watch(eng, steps)
            for r in _requests(cfg):
                eng.submit(r)
            tokens = []
            before = launch_counts()
            while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
                eng.step()
                tokens.append(eng.next_tokens.cpu().numpy().copy())
            after = launch_counts()
            st = eng.stats()
            with torch.no_grad(), meshlib.activate(mesh):
                logits, _ = api.prefill(eng.params, eng._prefill_batch(PROMPT), max_len=64)
            out[(arch, n, chunk)] = {
                "tokens": np.array(tokens), "stats": st, "live": eng.live_counters(),
                "role": eng.role_hits.copy(), "merged": merged, "steps": steps,
                "logits": meshlib.whole(logits).cpu().numpy(),
                "launches": {k: after[k] - before[k] for k in after},
                "dispatches": (eng.prefill_dispatches, eng.batch_decodes),
                "shapes": {k: tuple(p.to_local().shape) for k, p in eng.params.named_parameters()},
                "cache": {k: tuple(v.shape) for k, v in eng.cache.items()},
                "shard_rows": (eng.metrics.total("shard_near_hits"), eng.metrics.total("shard_far_hits")),
            }
    return out


# ---------------------------------------------------------------------------
# one engine case's checks (``port``: rank -> case -> run, as ``engine_run``
# returns them; ``ref``: case -> the reference's run; ``case``: (arch, n,
# chunk))


def check_tokens_and_books(port: list, ref: dict, case: tuple, world: int):
    """The tokens of every step on every rank, stats, live counters, role
    hits, the merged drained planes and the rows per shard equal the
    reference's; ranks past ``n`` ran nothing."""
    arch, n, chunk = case
    want = ref[case]
    for rank in range(n):
        got = port[rank][case]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["stats"] == want["stats"]
        assert got["live"] == want["live"]
        np.testing.assert_array_equal(got["role"], want["role"])
        for plane in ("near", "far", "slot", "tenant", "role"):
            np.testing.assert_array_equal(got["merged"][plane], want["merged"][plane], err_msg=plane)
        assert got["shard_rows"] == want["shard_rows"]
    dev = want["stats"]["device_tiering"]
    assert dev["shards"] == n and dev["near_hits"] > 0 and dev["far_hits"] > 0
    assert want["stats"]["requests_finished"] == N_REQUESTS
    assert all(case not in port[rank] for rank in range(n, world))


def check_prefill_logits(port: list, ref: dict, case: tuple, tol: float):
    """One prefill's logits within ``tol`` of their scale of the
    reference's, and every rank's the same."""
    want = ref[case]["logits"]
    scale = float(np.abs(want).max())
    for rank in range(case[1]):
        got = port[rank][case]["logits"]
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= tol * scale
        np.testing.assert_array_equal(got, port[0][case]["logits"])


def check_one_b1_launch_per_non_empty_shard(port: list, case: tuple):
    """Summed over the ranks, each step's lookup launches the gather once per
    shard holding one of its pages; a rank launches at most once."""
    per_rank = [port[rank][case]["steps"] for rank in range(case[1])]
    assert len({len(s) for s in per_rank}) == 1 and per_rank[0]
    for step in zip(*per_rank):
        busy = {b for b, _ in step}
        assert len(busy) == 1 and sum(launched for _, launched in step) == busy.pop()
        assert all(launched in (0, 1) for _, launched in step)
    assert port[0][case]["stats"]["device_tiering"]["dispatches"] == sum(
        launched for s in per_rank for _, launched in s)


# ---------------------------------------------------------------------------
# training across the mesh (``tests/test_torch_mesh_train.py``)

MESH_AXES = ("data", "pool", "model")


@contextlib.contextmanager
def backward_on_another_thread():
    """``torch.autograd.grad`` run on a thread of its own (one, kept for
    every call), as autograd runs a CUDA backward on its device thread: a
    remat recompute there must not depend on the caller's thread-local
    state (the active mesh)."""
    grad = torch.autograd.grad
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as worker:
        torch.autograd.grad = lambda *args, **kwargs: worker.submit(grad, *args, **kwargs).result()
        try:
            yield
        finally:
            torch.autograd.grad = grad


def _train_case(api, mesh, state_dict, batch: dict, opt):
    """Two steps of ``make_train_step`` at the pooled specs on ``mesh`` from
    ``state_dict``: (metrics a step, the placed model, AdamW's state, the
    specs)."""
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import make_train_step, trainable
    from repro_torch.optim import adamw_init

    model = api.init(0, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
    placed = meshlib.place_params(model, mesh, specs)
    state = adamw_init(trainable(placed))
    step = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs)
    metrics = []
    with backward_on_another_thread():
        for _ in range(2):
            placed, state, m = step(placed, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, placed, state, specs


def _whole_state(model, state) -> dict:
    """The model's parameters and AdamW's moments gathered whole (every rank
    takes part), as numpy by ``state_dict`` name."""
    from repro_torch.launch import mesh as meshlib

    # copies: a leaf replicated on every axis gathers to its own storage
    out = {"params": {n: meshlib.whole(p.detach()).numpy().copy() for n, p in model.named_parameters()}}
    for k in ("m", "v"):
        out[k] = {n: meshlib.whole(x).numpy().copy() for n, x in state[k].items()}
    return out


def _state_specs(specs):
    return specs, {"m": specs, "v": specs, "step": ()}


def train_run(rank: int, world: int, inp: dict, ckpt_dir: str) -> dict:
    """Every train case of ``inp`` (as ``tests/_jax_mesh_train.py`` takes
    it) over a ("data", "pool", "model") mesh of the case's shape: each
    step's metrics, the final parameters and moments whole (rank 0 only),
    and every rank's local shard shapes. Then the restores across meshes:
    for each arch of ``inp["restores"]``, its first case's state saved
    from its mesh (to ``ckpt_dir/<arch>``), restored onto (1, 4, 1) and
    onto one plain device (rank 0's full tensors, equal to what was saved),
    and the step after the restore on (1, 4, 1) beside a step from the
    saved state placed directly. Last, the mesh engine of ``inp["engine"]``
    with ``sp_activations`` on (``engine_run``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parity import params_from_jax

    opt = AdamWConfig(**inp["opt"])
    out = {"train": {}, "restore": {}}
    saved = {}
    for arch, shape, _, _ in inp["cases"]:
        api = get_model(_reduced(arch, inp))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=MESH_AXES)
        batch = {k: torch.from_numpy(v) for k, v in inp["batches"][arch].items()}
        metrics, model, state, specs = _train_case(api, mesh, params_from_jax(inp["trees"][arch]), batch, opt)
        whole = _whole_state(model, state)
        out["train"][(arch, shape)] = {
            "metrics": metrics, "whole": whole if rank == 0 else None,
            "shapes": {n: tuple(p.to_local().shape) for n, p in model.named_parameters()},
            "moments": {n: (tuple(state["m"][n].to_local().shape), tuple(state["v"][n].to_local().shape))
                        for n in state["m"]}}
        if arch in inp["restores"] and arch not in saved:  # its first case goes through a checkpoint
            CheckpointManager(f"{ckpt_dir}/{arch}").save(2, (model, state), {"step": 2})
            saved[arch] = (batch, whole, int(state["step"]))
        if "gather" not in out:
            # pooling.gather: each leaf at its compute placement, the same values
            out["gather"] = all(
                list(g.placements) == meshlib.placements(mesh, meshlib.leaf_spec(api.param_specs(), n), g.shape)
                and np.array_equal(meshlib.whole(g).numpy(), whole["params"][n])
                for n, g in pooling.gather(model, api.param_specs()))
    for arch, (batch, whole, step_no) in saved.items():
        out["restore"][arch] = _restore_case(rank, _reduced(arch, inp), batch, whole, step_no, f"{ckpt_dir}/{arch}",
                                             opt)
    arch_sp, n = inp["engine"]
    out["engine"] = engine_run(rank, world, {arch_sp: params_from_jax(inp["trees"][arch_sp.partition(":")[0]])},
                               False, [(arch_sp, n, 0)])
    return out


def _reduced(arch: str, inp: dict):
    """The case's reduced config, at ``inp["grad_accum"]``'s micro-batches
    where it names the arch."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    ga = inp.get("grad_accum", {}).get(arch)
    return cfg if ga is None else dataclasses.replace(cfg, grad_accum=ga)


def _restore_case(rank: int, cfg, batch: dict, whole: dict, step_no: int, ckpt_dir: str, opt) -> dict:
    """The state ``whole`` saved in ``ckpt_dir`` restored onto a (1, 4, 1)
    mesh and onto one plain device, and the step after the restore beside
    a step from ``whole`` placed directly (``train_run``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model, make_train_step, trainable
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.elastic import elastic_restore

    api = get_model(cfg)
    mgr = CheckpointManager(ckpt_dir)
    onto = init_device_mesh("cpu", (1, 4, 1), mesh_dim_names=MESH_AXES)
    specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), onto)
    template = api.init(0, device="cpu")
    (model, state), extras = elastic_restore(mgr, (template, adamw_init(trainable(template))), onto,
                                             _state_specs(specs))
    restored, restored_step = _whole_state(model, state), int(state["step"])
    plain_t = api.init(0, device="cpu")
    (plain, pstate), _ = elastic_restore(mgr, (plain_t, adamw_init(trainable(plain_t))))
    step = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs)
    _, _, m_restored = step(model, state, batch)
    direct_t = api.init(0, device="cpu")
    direct_t.load_state_dict({n: torch.from_numpy(a) for n, a in whole["params"].items()}, strict=True)
    direct = meshlib.place_params(direct_t, onto, specs)
    dstate = {k: {n: meshlib.distribute(torch.from_numpy(a), onto, meshlib.leaf_spec(specs, n))
                  for n, a in whole[k].items()} for k in ("m", "v")}
    dstate["step"] = torch.tensor(step_no, dtype=torch.int32)
    _, _, m_direct = step(direct, dstate, batch)
    after = (_whole_state(model, state), _whole_state(direct, dstate))
    return {
        "extras": extras, "step": restored_step,
        "restored": restored if rank == 0 else None, "saved": whole if rank == 0 else None,
        "plain": ({"params": {n: p.detach().numpy() for n, p in plain.named_parameters()},
                   "m": {n: x.numpy() for n, x in pstate["m"].items()},
                   "v": {n: x.numpy() for n, x in pstate["v"].items()}} if rank == 0 else None),
        "plain_step": int(pstate["step"]),
        "next": ({k: float(v) for k, v in m_restored.items()}, {k: float(v) for k, v in m_direct.items()}),
        "after": after if rank == 0 else None,
        "shapes": {n: tuple(p.to_local().shape) for n, p in model.named_parameters()},
    }
