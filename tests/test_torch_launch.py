"""The port's launch layer on the CPU: the serving launcher, the report,
the roofline, the op-level cost walk, the kernels' shape-only route and
work counts, the shape-only model entry points and the one-card dry run.

1. ``launch.serve`` prints the reference launcher's report for the same
   weights (the reference's ``PRNGKey(0)`` draw, carried over by
   ``parity.params_from_jax``) and arguments, all but the seconds.
2. ``launch.report`` renders the reference renderer's tables from the same
   cell dicts, all but the mesh headings.
3. ``launch.roofline``'s terms equal hand-computed ones at the H100's
   figures, per dtype and at the bf16 peak.
4. ``launch.op_analysis.walk`` on small known programs (a product, an
   elementwise op, views, an allocate/free sequence) and on a reduced
   dense prefill, whose product flops equal its layers' closed form.
5. Every kernel wrapper inside a walk on meta returns its plain version's
   shapes and dtypes and records ``kernels/work.py``'s count, no launch
   counted; outside a walk meta raises.
6. ``kernels/work.py`` gives the numbers ``PERF.md``'s kernel table was
   priced from.
7. ``ModelAPI.abstract_params`` matches the reference's abstract tree for
   every arch, name by name, with nothing drawn; reduced, it matches
   ``init`` on the CPU.
8. ``launch.dryrun`` walks one cell a family at full width on meta.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.kernels import build, work  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mamba2_scan import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan import ssd_chunked, ssd_train  # noqa: E402
from repro_torch.kernels.paged_attention import cache_as_pages, paged_attention  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6_chunked, wkv6_train  # noqa: E402
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    gather_rows,
    tiered_lookup_counted,
    tiered_lookup_segments,
)
from repro_torch.launch import dryrun, op_analysis, report, roofline, serve  # noqa: E402
from repro_torch.models import api as port_api  # noqa: E402
from repro_torch.models.api import get_model, make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

SERVE_ARGS = ["--arch", "smollm-360m", "--reduced", "--requests", "4"]
STACKS = ("layers", "enc_layers", "dec_layers")  # the reference's layer stacks


# ---------------------------------------------------------------------------
# 1. the serving launcher


@pytest.fixture(scope="module")
def reference_serve():
    """The reference launcher's report, and its weights as numpy."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_serve.main(SERVE_ARGS) == 0
    cfg = jax_config("smollm-360m").reduced()
    params = jax.tree.map(np.asarray, jax_model(cfg).init(jax.random.PRNGKey(0)))
    return buf.getvalue(), params


def _books(report_text: str) -> list:
    """The report's lines, the first cut before its seconds."""
    lines = report_text.strip().splitlines()
    return [lines[0].split(" in ")[0]] + lines[1:]


def test_serve_launcher_prints_the_reference_books(reference_serve, monkeypatch):
    text, params = reference_serve
    init = port_api.ModelAPI.init

    def reference_weights(self, seed=0, device=None):
        model = init(self, seed, device=device)
        model.load_state_dict(params_from_jax(params))
        return model

    monkeypatch.setattr(port_api.ModelAPI, "init", reference_weights)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(SERVE_ARGS + ["--device", "cpu"]) == 0
    port = _books(buf.getvalue())
    assert port == _books(text)
    assert port[0].startswith("[serve] Reader on smollm-360m: 4 requests") and len(port) == 10
    for key in ("prefill_tokens", "near_hit_rate", "migrations", "prefetch_accuracy"):
        assert any(line.split() and line.split()[0] == key for line in port), key
    assert port[-1].lstrip().startswith("page table:")


def test_serve_launcher_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(SERVE_ARGS)


# ---------------------------------------------------------------------------
# 2. the report


def _cell(arch, shape, ok=True, fits=True, frac=0.25, coll=0.0):
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": "h100x1", "ok": False,
                "error": "RuntimeError: no\ntrace", "pooled": 0}
    return {
        "arch": arch, "shape": shape, "mesh": "h100x1", "ok": True, "pooled": 0,
        "seconds_lower": 1.25, "seconds_compile": 0.0,
        "memory": {"peak_bytes": 3 * 2**30, "fits": fits},
        "collectives": {"op_counts": {"all-reduce": 2} if coll else {}},
        "roofline": {"compute_s": 0.01, "memory_kernel_adj_s": 0.02, "memory_s": 0.02,
                     "collective_s": coll, "bound": "memory", "useful_ratio": 0.5,
                     "roofline_fraction": frac},
    }


CELLS = [_cell("qwen2.5-3b", "train_4k", frac=0.1), _cell("qwen2.5-3b", "decode_32k", fits=False, coll=0.5),
         _cell("rwkv6-7b", "long_500k", ok=False), _cell("smollm-360m", "prefill_32k", frac=0.7)]


def test_report_renders_the_reference_tables(tmp_path):
    assert report.dryrun_table(CELLS) == ref_report.dryrun_table(CELLS)
    assert report.roofline_table(CELLS) == ref_report.roofline_table(CELLS)
    assert report.summary(CELLS) == ref_report.summary(CELLS)
    for mesh in ("pod1", "pod2"):  # the reference's meshes: the same tables
        (tmp_path / mesh).mkdir()
        for c in CELLS:
            (tmp_path / mesh / f"{c['arch']}__{c['shape']}.json").write_text(json.dumps(c))
    outs = []
    for mod in (report, ref_report):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--dir", str(tmp_path)])
        outs.append([line for line in buf.getvalue().splitlines() if not line.startswith("## ")])
    assert outs[0] == outs[1]
    (tmp_path / "h100x1").mkdir()
    for c in CELLS:
        (tmp_path / "h100x1" / f"{c['arch']}__{c['shape']}.json").write_text(json.dumps(c))
    text = _render(tmp_path)
    assert "## Dry-run — h100x1 (1 × NVIDIA H100 80GB HBM3, 700 W)" in text
    assert "## Dry-run — pod1 (16×16 = 256 × NVIDIA H100 80GB HBM3, 700 W)" in text
    assert "## Dry-run — pod2 (2×16×16 = 512 × NVIDIA H100 80GB HBM3, 700 W)" in text


def _render(path) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", str(path)])
    return buf.getvalue()


# ---------------------------------------------------------------------------
# 3. the roofline


def test_roofline_terms_at_the_h100_figures():
    cost = op_analysis.Cost()
    cost.product_flops_by_dtype.update({"bfloat16": 2 * 989e12, "float32": 67e12})
    cost.flops_by_dtype.update({"bfloat16": 2 * 989e12, "float32": 67e12 + 3 * 67e12})  # + elementwise
    cost.tagged_flops["flash_attention"] = 495e12 / 3
    cost.kernel_seconds["flash_attention"] = 1.0  # f32 flash: three TF32 products a product
    cost.flops = sum(cost.flops_by_dtype.values()) + 495e12 / 3
    cost.bytes = 2 * 3.35e12
    cost.collective_bytes["all-reduce"] = 450e9
    cost.collectives["all-reduce/4/nvlink"] = {"kind": "all-reduce", "group": 4, "link": "nvlink",
                                               "bytes": 450e9, "ops": 1}
    t = roofline.roofline(cost=cost, n_params=1e9, n_tokens=1e3, kind="train")
    assert t.compute_s == pytest.approx(2.0 + 1.0 + 3.0 + 1.0, rel=1e-12)  # bf16, f32, elementwise, kernel
    assert t.memory_s == pytest.approx(2.0) and t.memory_kernel_adj_s == t.memory_s
    assert t.collective_s == pytest.approx(2 * 450e9 * 3 / 4 / 450e9)
    assert t.detail["compute_at_bf16_s"] == pytest.approx(cost.flops / 989e12)
    assert t.bound == "compute" and t.model_flops == 6e12 and t.useful_ratio == pytest.approx(6e12 / cost.flops)
    assert roofline.roofline_fraction(t) == pytest.approx(6e12 / 989e12 / 7.0)
    serve_t = roofline.roofline(cost=cost, n_params=1e9, n_tokens=1e3, kind="serve")
    assert serve_t.model_flops == 2e12
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_FP32) == (989e12, 495e12, 67e12)
    assert (hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == (3.35e12, 80 * 2**30, 450e9)


# ---------------------------------------------------------------------------
# 4. the cost walk


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walk_counts_a_product(dtype):
    m, k, n = 48, 32, 24
    _, cost = op_analysis.walk(lambda a, b: a @ b, _meta(m, k, dtype=dtype), _meta(k, n, dtype=dtype))
    name = str(dtype)[6:]
    assert cost.flops == 2 * m * n * k == cost.product_flops_by_dtype[name] == cost.flops_by_dtype[name]
    assert cost.bytes == (m * k + k * n + m * n) * dtype.itemsize


def test_walk_counts_elementwise_ops_and_expanded_operands():
    a, b = _meta(64, 32), _meta(32)
    _, cost = op_analysis.walk(lambda x, y: torch.exp(x + y), a, b)
    assert cost.flops == 2 * 64 * 32 and cost.transcendentals == 64 * 32
    assert cost.product_flops_by_dtype == {}
    # add reads a and b once each (b is broadcast) and writes; exp reads and writes
    assert cost.bytes == 4 * (64 * 32 + 32 + 64 * 32) + 4 * 2 * 64 * 32
    _, cost = op_analysis.walk(lambda x: x.sum(), a)
    assert cost.flops == 64 * 32 / 2  # a reduction: half an operand element, as the reference's


def test_walk_gives_views_no_bytes():
    a = _meta(16, 8)
    _, cost = op_analysis.walk(lambda x: x.view(4, 32).t()[2:].unsqueeze(0).expand(3, -1, -1), a)
    assert cost.ops >= 4 and cost.bytes == 0 and cost.flops == 0


def test_walk_prices_a_copy_a_gather_and_a_scatter():
    dst, src = _meta(100, 8), _meta(100, 8)
    _, cost = op_analysis.walk(lambda d, s: d.copy_(s), dst, src)
    assert cost.bytes == 2 * 100 * 8 * 4  # src read, dst written, dst not read
    idx = torch.empty(10, dtype=torch.int64, device="meta")
    _, cost = op_analysis.walk(lambda s, i: s[i], src, idx)
    assert cost.bytes == 2 * 10 * 8 * 4  # the selected rows read, the output written
    _, cost = op_analysis.walk(lambda d, i, v: d.index_put_((i,), v), dst, idx, _meta(10, 8))
    assert cost.bytes == 2 * 10 * 8 * 4  # the updated rows read and written


def test_walk_tracks_the_peak_over_allocations_and_frees():
    arg = _meta(100)  # 400 bytes, live from the start

    def program(x):
        a = torch.empty(1000, device="meta")  # 4,000
        b = torch.empty(2000, device="meta")  # 8,000
        del a
        c = torch.empty(500, device="meta")  # 2,000, where a was
        return b, c

    _, cost = op_analysis.walk(program, arg)
    assert cost.peak_bytes == 400 + 4000 + 8000


# a functional all-gather of 1,024 f32 over the world group of a fake process
# group of 4 ranks, walked in a process of its own (a fake group never starts
# in one that serves or trains)
COLLECTIVE_WALK = """
import json, torch, torch.distributed as dist
from repro_torch.launch import mesh as meshlib, op_analysis, roofline
x = torch.empty(1024, device="meta")
with meshlib.fake_process_group(4):
    name = dist.group.WORLD.group_name
    _, cost = op_analysis.walk(lambda t: torch.ops._c10d_functional.all_gather_into_tensor(t, 4, name), x)
print(json.dumps({"ops": cost.collective_ops, "bytes": cost.collective_bytes, "groups": cost.group_sizes,
                  "by_group": cost.collectives,
                  "seconds": roofline.roofline(cost=cost, n_params=1, n_tokens=1).collective_s}))
"""


def test_walk_counts_collectives_by_kind():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", COLLECTIVE_WALK], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["ops"] == {"all-gather": 1} and got["bytes"] == {"all-gather": 4096.0}
    assert got["groups"] == {"all-gather": 4.0}
    assert got["by_group"] == {"all-gather/4/nvlink": {"kind": "all-gather", "group": 4, "link": "nvlink",
                                                       "bytes": 4096.0, "ops": 1}}
    assert got["seconds"] == pytest.approx(4096.0 * 3 / 4 / hw.NVLINK_BW)
    # a group the running process group does not resolve is not priced by a guess
    with pytest.raises(RuntimeError, match="resolve"):
        op_analysis.walk(lambda t: torch.ops._c10d_functional.all_gather_into_tensor(t, 4, "0"), _meta(1024))


def test_walk_of_a_reduced_dense_prefill_counts_its_products():
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), d_model=256, n_heads=4, n_kv_heads=2)
    api = get_model(cfg)
    b, l = 2, 48
    step = make_prefill_step(api, max_len=64)
    with torch.no_grad():
        params = api.abstract_params()
        _, cost = op_analysis.walk(step, params, {"tokens": _meta(b, l, dtype=torch.int32)})
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    per_layer = 2 * b * l * d * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) + 2 * b * l * cfg.n_heads * hd * d \
        + 3 * 2 * b * l * d * f
    assert cost.flops_by_dtype and sum(cost.product_flops_by_dtype.values()) == \
        cfg.n_layers * per_layer + 2 * b * l * d * cfg.padded_vocab
    flash = work.flash_attention(b, cfg.n_heads, cfg.n_kv_heads, l, l, hd, 4, True)
    assert cost.kernel_calls == {"flash_attention": cfg.n_layers}
    assert cost.tagged_flops["flash_attention"] == cfg.n_layers * flash[1]
    assert cost.tagged_bytes["flash_attention"] == cfg.n_layers * flash[0]


def test_walk_holds_one_cast_per_leaf_on_meta():
    """Every meta tensor has data_ptr 0: the held casts (``common.cast``)
    stay one per leaf, each of its leaf's shape."""
    cfg = get_config("smollm-360m")
    api = get_model(cfg)
    params, cache = api.abstract_params(), api.abstract_cache(2, 32)
    with torch.no_grad():
        op_analysis.walk(make_serve_step(api), params, cache, _meta(2, 1, dtype=torch.int32))
    seen = set()
    for module in params.modules():
        for (name, _), (_, held) in module.__dict__.get("_casts", {}).items():
            assert held.shape == getattr(module, name).shape and held.dtype == torch.bfloat16
            seen.add(id(held))
            assert held.untyped_storage()._cdata != getattr(module, name).untyped_storage()._cdata
    assert len(seen) > cfg.n_layers * 4


# ---------------------------------------------------------------------------
# 5. the shape-only route


def _cpu_and_meta(fn, args, kwargs=None):
    """fn on the CPU tensors, and on their meta twins inside a walk: both
    outputs as flat lists, the walk's cost, the launch counts' change."""
    kwargs = kwargs or {}
    out_cpu = fn(*args, **kwargs)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    before = launch_counts()
    out_meta, cost = op_analysis.walk(fn, *meta, **kwargs)
    assert launch_counts() == before
    flat = lambda o: [x for x in (o if isinstance(o, tuple) else (o,)) if x is not None]
    return flat(out_cpu), flat(out_meta), cost


def _same_shapes(cpu, meta):
    assert [(tuple(t.shape), t.dtype) for t in cpu] == [(tuple(t.shape), t.dtype) for t in meta]
    assert all(t.is_meta for t in meta)


def _rand(*shape, dtype=torch.float32, g=None):
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_shape_only_route(return_lse, dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = _rand(2, 4, 24, 64, dtype=dtype, g=g), _rand(2, 2, 24, 64, dtype=dtype, g=g), \
        _rand(2, 2, 24, 64, dtype=dtype, g=g)
    cpu, meta, cost = _cpu_and_meta(flash_attention, (q, k, v), dict(causal=True, return_lse=return_lse))
    _same_shapes(cpu, meta)
    want = work.flash_attention(2, 4, 2, 24, 24, 64, dtype.itemsize, True, 0, 24, return_lse)
    assert cost.kernel_calls == {"flash_attention": 1}
    assert (cost.tagged_bytes["flash_attention"], cost.tagged_flops["flash_attention"]) == want[:2]
    assert cost.kernel_seconds["flash_attention"] == want[1] / want[2]


def test_paged_shape_only_route():
    g = torch.Generator().manual_seed(1)
    kc, vc = _rand(3, 2, 32, 64, dtype=torch.bfloat16, g=g), _rand(3, 2, 32, 64, dtype=torch.bfloat16, g=g)
    q = _rand(3, 4, 64, dtype=torch.bfloat16, g=g)
    lengths = torch.tensor([1, 17, 32], dtype=torch.int32)

    def decode(q, kc, vc, lengths):
        kp, vp, table = cache_as_pages(kc, vc, 16)
        return paged_attention(q, kp, vp, table, lengths)

    cpu, meta, cost = _cpu_and_meta(decode, (q, kc, vc, lengths))
    _same_shapes(cpu, meta)
    want = work.paged_attention(3, 4, 2, 64, 2, 2, 2, 16)  # every sequence as long as its pages
    assert cost.kernel_calls == {"paged_attention": 1}
    assert cost.tagged_bytes["paged_attention"] == want[0] and cost.tagged_flops["paged_attention"] == want[1]


def _wkv6_args(state: bool, g):
    b, t, h, hd = 2, 40, 2, 16
    lw = -torch.rand((b, t, h, hd), generator=g)
    return (_rand(b, t, h, hd, g=g), _rand(b, t, h, hd, g=g), _rand(b, t, h, hd, g=g), lw,
            _rand(h, hd, g=g), _rand(b, h, hd, hd, g=g) if state else None)


def _ssd_args(state: bool, g):
    b, t, h, p, n = 2, 40, 3, 16, 16
    return (_rand(b, t, h, p, g=g), torch.rand((b, t, h), generator=g), -torch.rand(h, generator=g),
            _rand(b, t, n, g=g), _rand(b, t, n, g=g), _rand(h, g=g), _rand(b, h, p, n, g=g) if state else None)


@pytest.mark.parametrize("mode", ["zero", "state", "inplace", "states", "train"])
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_scan_shape_only_route(scan, mode):
    g = torch.Generator().manual_seed(2)
    args = (_wkv6_args if scan == "wkv6" else _ssd_args)(mode in ("state", "inplace"), g)
    op = {("wkv6", False): wkv6_chunked, ("wkv6", True): wkv6_train,
          ("ssd", False): ssd_chunked, ("ssd", True): ssd_train}[(scan, mode == "train")]
    kw = {"inplace": mode == "inplace", "return_states": mode == "states"} if mode != "train" else {}
    if mode == "inplace":
        args = args[:-1] + (args[-1].clone(),)
    cpu, meta, cost = _cpu_and_meta(op, args, kw)
    _same_shapes(cpu, meta)
    with_state = mode in ("state", "inplace")
    if scan == "wkv6":
        b, t, h, hd = args[0].shape
        want = work.wkv6(b, t, h, hd, with_state, mode in ("states", "train"))
    else:
        b, t, h, p = args[0].shape
        want = work.ssd(b, t, h, p, args[3].shape[2], with_state, mode in ("states", "train"))
    assert cost.kernel_calls == {scan: 1}
    assert (cost.tagged_bytes[scan], cost.tagged_flops[scan]) == want[:2]


def _store(g):
    hot = _rand(6, 32, g=g)
    cold_q = torch.randint(-127, 128, (10, 32), generator=g, dtype=torch.int8)
    scales = torch.rand(10, generator=g)
    tier = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1, 1, 0], dtype=torch.int32)
    slot = torch.tensor([0, 0, 1, 1, 2, 2, 3, 4, 5, 3], dtype=torch.int32)
    ids = torch.tensor([0, 1, 2, 3, 3, 9, 7], dtype=torch.int32)
    return hot, cold_q, scales, tier, slot, ids


def test_tiered_shape_only_routes():
    g = torch.Generator().manual_seed(3)
    hot, cold_q, scales, tier, slot, ids = _store(g)
    seg_of = torch.tensor([0, 0, 1, 1, 1, 2, 2], dtype=torch.int32)
    for name, fn, args, want in (
        ("tiered_segmented", tiered_lookup_segments, (hot, cold_q, scales, tier, slot, ids, seg_of, 3),
         work.tiered_lookup(7, 32, 4, 3)),
        ("tiered_gather", tiered_lookup_counted, (hot, cold_q, scales, tier, slot, ids),
         work.tiered_lookup(7, 32, 4, 1)),
        ("gather_rows", gather_rows, (cold_q, ids, scales), work.gather_rows(7, 32, 1, True)),
        ("gather_rows", gather_rows, (hot, ids[:3]), work.gather_rows(3, 32, 4, False)),
    ):
        cpu, meta, cost = _cpu_and_meta(fn, args)
        _same_shapes(cpu, meta)
        assert cost.kernel_calls == {name: 1}
        assert (cost.tagged_bytes[name], cost.tagged_flops[name]) == want[:2]


def test_meta_outside_a_walk_raises():
    q = _meta(1, 2, 8, 64)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gather_rows(_meta(4, 8), torch.empty(2, dtype=torch.int32, device="meta"))
    assert not build.WALKS and not build.kernel_route(q)


# ---------------------------------------------------------------------------
# 6. kernels/work.py: the numbers PERF.md's kernel table was priced from


def test_work_gives_the_kernel_tables_numbers(monkeypatch):
    from repro_torch.kernels.compare import serving_store

    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    hot, _, _, tier, _, ids, _, n_seg = serving_store(0)
    b1 = work.tiered_lookup(ids.numel(), hot.shape[1], 4, n_seg, ids=ids.numpy(), tier=tier.numpy())
    assert round(b1[0] / 1e6, 1) == 55.0  # B1: 55.0 MB
    assert round(work.wkv6(1, 512, 64, 64, False)[0] / 1e6, 1) == 43.0  # B6 prefill: 43.0 MB
    assert round(work.ssd(1, 512, 64, 64, 64, False)[1] / 1e9, 2) == 0.62  # B7 prefill: 0.62 GFLOP
    b5 = work.flash_attention(4, 15, 5, 4096, 4096, 64, 2, True, return_lse=True)
    assert round(b5[1] / 1e9, 1) == 128.9 and b5[2] == hw.PEAK_FLOPS_BF16  # B5 training: 128.9 GFLOP
    assert work.CHUNK == wkv6_ref.CHUNK == ssd_ref.CHUNK
    f32 = work.flash_attention(1, 32, 32, 512, 512, 64, 4, True)
    assert f32[2] == hw.PEAK_FLOPS_TF32 / 3
    # lengths as given, and the full pages without them
    assert work.paged_attention(2, 4, 2, 64, 2, 2, 4, 16, [3, 100])[1] == 4.0 * 4 * 64 * (3 + 64)
    assert work.paged_attention(2, 4, 2, 64, 2, 2, 4, 16)[1] == 4.0 * 4 * 64 * 128


# ---------------------------------------------------------------------------
# 7. the shape-only model entry points


def _reference_shapes(arch: str) -> dict:
    """The reference's abstract params (``jax.eval_shape``) under the port's
    state_dict names: a stacked layer leaf (L, ...) as L leaves."""
    tree = jax_model(jax_config(arch)).abstract_params()
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in STACKS:
            for i in range(leaf.shape[0]):
                out[".".join([keys[0], str(i), *keys[1:]])] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def test_abstract_params_match_the_reference_for_every_arch(monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("abstract_params drew a value")

    monkeypatch.setattr(torch, "rand", no_draw)
    monkeypatch.setattr(torch, "randn", no_draw)
    assert list_archs() == jax_archs()
    for arch in list_archs():
        params = get_model(get_config(arch)).abstract_params()
        got = {n: (tuple(p.shape), str(p.dtype)[6:]) for n, p in params.named_parameters()}
        assert all(p.is_meta for p in params.parameters()), arch
        want = _reference_shapes(arch)
        assert got == want, arch
        assert sum(np.prod(s) for s, _ in got.values()) == sum(np.prod(s) for s, _ in want.values())


def test_reduced_abstract_params_match_init():
    for arch in list_archs():
        api = get_model(get_config(arch).reduced())
        meta = dict(api.abstract_params().named_parameters())
        cpu = dict(api.init(0, device="cpu").named_parameters())
        assert list(meta) == list(cpu), arch
        assert all(meta[n].shape == cpu[n].shape and meta[n].dtype == cpu[n].dtype for n in cpu), arch


def test_input_specs_and_abstract_cache():
    for arch, keys in (("qwen2.5-3b", {"tokens", "labels"}), ("qwen2-vl-7b", {"embeds", "mrope_positions", "labels"}),
                       ("whisper-base", {"tokens", "frames", "labels"})):
        api = get_model(get_config(arch))
        spec = api.input_specs("train_4k")
        assert set(spec) == keys and all(t.is_meta for t in spec.values())
        assert spec["labels"].shape == (256, 4096) and spec["labels"].dtype == torch.int32
        assert set(api.input_specs("prefill_32k")) == keys - {"labels"}
    vlm = get_model(get_config("qwen2-vl-7b")).input_specs("prefill_32k")
    assert vlm["embeds"].dtype == torch.bfloat16 and vlm["mrope_positions"].shape == (3, 32, 32768)
    dec = get_model(get_config("zamba2-1.2b")).input_specs("long_500k")
    assert dec["tokens"].shape == (1, 1) and all(t.is_meta for t in dec["cache"].values())
    cpu = get_model(get_config("zamba2-1.2b").reduced()).init_cache(2, 32, device="cpu")
    meta = get_model(get_config("zamba2-1.2b").reduced()).abstract_cache(2, 32)
    assert {k: (v.shape, v.dtype) for k, v in cpu.items()} == {k: (v.shape, v.dtype) for k, v in meta.items()}


# ---------------------------------------------------------------------------
# 8. the dry run


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "prefill_32k"),        # dense
    ("granite-moe-3b-a800m", "decode_32k"),  # moe
    ("rwkv6-7b", "long_500k"),             # ssm
    ("zamba2-1.2b", "decode_32k"),         # hybrid
    ("qwen2-vl-7b", "decode_32k"),         # vlm
    ("whisper-base", "prefill_32k"),       # audio
])
def test_dryrun_walks_one_cell_a_family(arch, shape):
    res = dryrun.run_cell(arch, shape, interactive_log=lambda *_: None)
    assert res.ok, res.error
    cell = json.loads(json.dumps(res.as_dict()))
    assert cell["mesh"] == "h100x1" and cell["seconds_compile"] == 0.0
    mem = cell["memory"]
    assert mem["hbm_budget"] == hw.HBM_BYTES and mem["fits"] == (mem["peak_bytes"] <= hw.HBM_BYTES)
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    r = cell["roofline"]
    assert r["bound"] in ("compute", "memory") and r["collective_s"] == 0.0 and 0 < r["roofline_fraction"] < 1
    assert cell["cost"]["flops"] > 0 and cell["cost"]["kernel_calls"]
    assert report.dryrun_table([cell]).count("\n") == 2


def test_dryrun_lists_32_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "32 cells" in out and out.count("long_500k") >= 2
