#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. device and build: the card's name and power limit, TF32 off, every CUDA
   kernel built from ``src/repro_torch/csrc`` with nvcc, in parallel; the
   four flash kernels' SASS holds wgmma (HGMMA) and TMA loads (UTMALDG),
   the two f32 ones TF32 tensor-core products (HGMMA on TF32, and HMMA on
   TF32 at D = 128);
2. kernels against their plain PyTorch versions at the serving step's
   shapes, then timed with CUDA events next to the plain version, the
   least time the card could take, and the one PyTorch call that computes
   the same function where there is one:
   - the tiered gathers (D = 2*32*5*64 = 20480, N = 512, 307 of 1024
     pages near, 9 segments): rows and counters bit-exact;
   - flash attention (prefill of 512 tokens) and paged decode attention
     (8 slots, S = 1024, pages of 16, through the cache view, each sequence
     split over a cluster of blocks) at the widths of smollm-360m,
     qwen2.5-3b and granite-moe-3b (24/8 heads of 64), bf16, and
     zamba2-1.2b, f32 (flash on TF32 tensor cores,
     three products a product): within one bf16 step (2e-5 in f32) of the
     plain version, and within 2e-2 of the model's eager attention;
   - B5 over prompts of 64 to 1024 and B4 over lengths all 1, the main
     ones and all 1024, beside the timing's floor, to show where their
     time goes;
   - the scans, f32: WKV6 at rwkv6-7b's widths (64 heads of 64) and the
     Mamba2 SSD at zamba2-1.2b's (64 heads, P = N = 64), each on a prompt
     of 512 from a zero and from a random state and on a decode step of 8
     slots, with decays up to e^-10 a step: y and the final state within
     the stated f32 tolerance of the plain version; each prompt split over
     a cluster of ``split_count`` blocks, whose clusters must all be
     resident on the card at once;
3. the main path: a device-tiered ``ServingEngine`` over full-width
   smollm-360m (32 layers, random weights from a seed) answering 16 Web1
   requests, each decode dispatch one replay of the decode the engine
   captured as a CUDA graph -- every request finishes, one tiered-gather
   launch per step, one flash launch per layer per prefill and one paged
   launch per layer per decode, both tiers hit, logits finite, decode-only
   steps free of host reads, and a profile of decode steps;
   3b. the same over full-width qwen2.5-3b (36 layers, d 2048, 16/2 heads,
   d_ff 11008, vocab 151936) on 6 Web1 requests;
   3c. the same over full-width rwkv6-7b (32 layers, d 4096, 64 wkv heads
   of 64, d_ff 14336, vocab 65536) on 6 Web1 requests: one WKV6 launch per
   layer per prefill and per decode, no attention launch;
   3d. the same over full-width zamba2-1.2b (38 Mamba2 layers, d 2048, 64
   SSD heads of 64, N = 64, 6 applications of the shared attention block
   of 32 heads of 64) on 8 Web1 requests: one SSD launch per layer, and
   one flash (prefill) or paged (decode) launch per application, per
   dispatch;
   3e. the same over full-width granite-moe-3b-a800m (32 layers, d 1536,
   24/8 heads of 64, 40 experts top-8 of 512, capacity-bounded routing of
   the whole batch as one group inside the captured decode) on 6 Web1
   requests: one flash launch per layer per prefill and one paged launch
   per layer per decode; then one decode of 8 slots through the sort
   dispatch held to the einsum dispatch's logits (``SORT_TOL``), and the
   experts' share of a decode step;
   3x. after each model's main path, continuous batching with chunked
   prefill on the same params and requests (``prefill_chunk=64``): every
   request finishes, one model and one tiered dispatch a step, no prefill
   dispatch, no host read in any step that does not drain, and the model
   kernels once a layer per whole-batch decode (a decode step, or a chunk
   column, each a graph replay); TTFT, tokens/s, step time, and the share
   of requests whose tokens equal the whole-slot engine's;
4. the verify paths at full width on 4 requests: identity scales with the
   in-line flat-mirror probe (no read error), the per-slot lookup baseline
   (same drained hit totals), device tiering off (same live counters); and
   reduced smollm, rwkv6 and zamba2 models on the card (kernels, graphs)
   against the same engine on the CPU (plain versions), whole-slot and
   chunked;
5. the fleet (``repro_torch.fleet``) at full width: the objects
   ``build_fleet`` wires (router, admission with the chaos study's two
   tenants, AutoTierer, elastic layer, chaos engine) over 3 device-tiered
   smollm-360m engines sharing phase 3's params, trace prediction and the
   prefetch issue window on, through a crash with a replacement host, a
   hang, and a degraded host whose window holds two placement epochs: one
   tiered launch a step on every host, no host read in a step that neither
   drains nor admits, no near hit on the degraded host in its window and
   its pushes rejected, pages promoted, every fault applied on time, every
   request completed, failed or shed, and each host's model kernels once
   a layer per prefill and per decode; then the same wiring over the
   reduced head_dim-64 smollm on the card and on the CPU, with equal chaos
   logs, outcome ledgers and fleet books;
6. one JSON line with every kernel's numbers, then the result line,
   printed last, after phase 7;
7. the sharded engine on one card: phase 3's smollm-360m params and
   requests with the tiered store split into 1, 2 and 4 page-interleaved
   shards (``model_shards``): bit-identical tokens, equal merged drained
   planes and books, B1 once per non-empty shard a step, no host read in
   a step that neither drains nor admits, one read a dirty shard a drain.

Each path's kernel launch counts are zeroed just before it and read just
after, so the counts show which kernels each path went through. A path's
launches are the wrappers' counts (eager launches: the prefills, the
tiered lookups) plus the engine's graph replays times the launches each
captured graph holds (``ServingEngine.graph_launches``): the wrappers'
counts are Python increments, made once at capture and not at a replay.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores
TF32_PRODUCTS = 3  # TF32 products the f32 flash kernel takes for one f32-exact product
CSRC = "src/repro_torch/csrc"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "tiered_segmented": ("tiered_gather.cu", "src/repro/kernels/tiered_gather/kernel.py:133"),
    "tiered_gather": ("tiered_gather.cu", "src/repro/kernels/tiered_gather/kernel.py:186"),
    "gather_rows": ("tiered_gather.cu", "src/repro/kernels/tiered_gather/kernel.py:52"),
    "paged_attention": ("paged_attention.cu", "src/repro/kernels/paged_attention/kernel.py:73"),
    "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:76"),
    "wkv6": ("wkv6.cu", "src/repro/kernels/rwkv6_scan/kernel.py:77"),
    "ssd": ("ssd.cu", "src/repro/kernels/mamba2_scan/kernel.py:76"),
}
# the attention widths of the served models: (query heads, KV heads, head_dim)
ATTN_WIDTHS = {"smollm-360m": (15, 5, 64), "qwen2.5-3b": (16, 2, 128), "zamba2-1.2b": (32, 32, 64),
               "granite-moe-3b-a800m": (24, 8, 64)}
# zamba2's shared block runs uncast f32 weights (as the reference's prefill
# and decode do): f32 q, k, v in prefill, an f32 query over the bf16 cache
# in decode; the dense models feed bf16 throughout
ATTN_F32_Q = {"zamba2-1.2b"}
PREFILL_LEN = 512  # Web1's mean prompt
# the decode check's 8 slots over S = 1024: one token, a partial page, a
# full page run, ragged lengths near the main path's, the full cache, and
# a length past the cache's end (an inactive slot that kept decoding)
DECODE_S, DECODE_PAGE = 1024, 16
DECODE_LENGTHS = (1, 23, 512, 547, 560, 600, 1024, 1300)
# the main path's engine, for every model
ECFG = dict(max_batch=8, max_len=1024, page_size=16, n_pages=1024, near_frac=0.3,
            device_tiering=True)
# the models whose attention numbers ride beside smollm-360m's in the kernels line
MODELS_BESIDE = ("qwen2.5-3b", "zamba2-1.2b", "granite-moe-3b-a800m")
# the main path on smollm-360m with eager attention, as measured at commit
# 0f3184b (NVIDIA H100 80GB HBM3, 700 W)
EAGER_BASELINE = ("eager attention at commit 0f3184b on NVIDIA H100 80GB HBM3, 700 W: "
                  "43.8 tokens/s, step p50 92.6 ms, p99 335.2 ms")


def log(msg: str):
    print(msg, flush=True)


def sass_counts(lib: Path):
    """The flash kernels run their products as wgmma (HGMMA in SASS) on
    tiles that TMA loads (UTMALDG), and the f32 ones (``fa_tc_kernel<float,
    D>``) on TF32: S = Q K^T as TF32 wgmma (HGMMA...TF32), P V as TF32
    wgmma at D = 64 and as TF32 mma.sync (HMMA...TF32) at D = 128. Count
    them in each compiled kernel with cuobjdump (beside the nvcc that built
    them), and fail if an instance lacks one."""
    from repro_torch.kernels import build

    counts, func = {}, None
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            counts[func] = {"HGMMA": 0, "UTMALDG": 0, "HGMMA.TF32": 0, "HMMA.TF32": 0}
        elif func:
            for op in ("HGMMA", "UTMALDG"):
                counts[func][op] += op + "." in line or op + " " in line
            for op in ("HGMMA", "HMMA"):
                counts[func][op + ".TF32"] += op + "." in line and "TF32" in line
    for func, c in counts.items():
        log(f"  sass {func[:70]}: {c}")
    tc = {f: c for f, c in counts.items() if "fa_tc_kernel" in f}
    f32 = [c for f, c in tc.items() if "fa_tc_kernelIf" in f]
    assert len(tc) == 4 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in tc.values()), counts
    assert len(f32) == 2 and all(c["HGMMA.TF32"] > 0 for c in f32), counts
    assert [c["HMMA.TF32"] > 0 for f, c in tc.items() if "fa_tc_kernelIfLi128" in f] == [True], counts


def time_ms(fn, reps: int = 60) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls, the L2
    flushed before each (``repro_torch.kernels.timing``)."""
    from repro_torch.kernels import timing

    return timing.time_ms(fn, reps)


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(least time in ms, what bounds it) at the card's published peaks;
    ``ops_per_s`` is the peak for the operations' input type."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _counters():
    from repro_torch.kernels import (flash_attention, mamba2_scan, paged_attention, rwkv6_scan,
                                     tiered_gather)

    return (tiered_gather.LAUNCHES, flash_attention.LAUNCHES, paged_attention.LAUNCHES,
            rwkv6_scan.LAUNCHES, mamba2_scan.LAUNCHES)


def launch_counts() -> dict:
    from repro_torch import kernels

    return kernels.launch_counts()


def zero_launch_counts():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def kernel_inputs(near_dtype, seed: int = 0):
    """The serving step's store at full width
    (``repro_torch.kernels.compare.serving_store``): 1024 pages of D = 20480,
    307 of them near (their slots a permutation), the rest far int8 with
    per-row scales; 512 gathers (8 ragged slot walks over shared prefix
    pages, padded to the 512 bucket into segment 8, as lookup_segments does)."""
    from repro_torch.kernels.compare import serving_store

    hot, cold_q, cold_scales, tier, slot, ids, seg_of, n_seg = serving_store(seed)
    return {
        "hot": hot.to(near_dtype), "cold_q": cold_q, "cold_scales": cold_scales, "tier": tier,
        "slot": slot, "ids": ids, "seg_of": seg_of, "n_segments": n_seg,
        "np": {"tier": tier.cpu().numpy(), "slot": slot.cpu().numpy(), "ids": ids.cpu().numpy(),
               "d": hot.shape[1]},
    }


def tiered_bytes(x, near_itemsize: int, n_seg: int) -> float:
    """Bytes one tiered lookup must move: ids (and segment ids), the tier and
    slot entries of each distinct page, each distinct selected row once (a
    far row with its scale), the (N, D) f32 rows and the hit table written."""
    tier, ids, d = x["np"]["tier"], x["np"]["ids"], x["np"]["d"]
    pages = np.unique(ids)
    n_near = int((tier[pages] == 0).sum())
    n_far = pages.size - n_near
    reads = ids.size * 4 * 2 + pages.size * 8 + n_near * d * near_itemsize + n_far * (d + 4)
    writes = ids.size * d * 4 + n_seg * 2 * 4
    return float(reads + writes), float(ids.size - int((tier[ids] == 0).sum())) * d


def check_kernels():
    import torch

    from repro_torch.kernels.tiered_gather import ops, ref

    results = {}
    # B1 tiered_segmented, f32 (the engine's store) and bf16 near
    for near_dtype in (torch.float32, torch.bfloat16):
        x = kernel_inputs(near_dtype)
        args = (x["hot"], x["cold_q"], x["cold_scales"], x["tier"], x["slot"], x["ids"],
                x["seg_of"], x["n_segments"])
        rows_k, hits_k = ops.tiered_lookup_segments(*args)
        rows_p, hits_p = ref.tiered_lookup_segments_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(rows_k, rows_p), f"tiered_segmented rows differ ({near_dtype})"
        assert torch.equal(hits_k, hits_p), f"tiered_segmented counters differ ({near_dtype})"
        err = float((rows_k - rows_p).abs().max())
        log(f"B1 tiered_segmented near={near_dtype}: rows and (9, 2) counters bit-exact "
            f"(max_abs_err {err}), hits {hits_k.sum(0).tolist()}")
        if near_dtype == torch.float32:
            nbytes, nops = tiered_bytes(x, 4, x["n_segments"])
            b_ms, b_by = bound(nbytes, nops)
            results["tiered_segmented"] = {
                "max_abs_err": err,
                "ms": time_ms(lambda: ops.tiered_lookup_segments(*args)),
                "plain_ms": time_ms(lambda: ref.tiered_lookup_segments_ref(*args)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "bytes": nbytes,
            }
    # B2 tiered_gather: one segment, counters as scalars
    x = kernel_inputs(torch.float32, seed=1)
    args = (x["hot"], x["cold_q"], x["cold_scales"], x["tier"], x["slot"], x["ids"])
    rows_k, near_k, far_k = ops.tiered_lookup_counted(*args)
    rows_p, near_p, far_p = ref.tiered_lookup_counted_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(rows_k, rows_p), "tiered_gather rows differ"
    assert int(near_k) == int(near_p) and int(far_k) == int(far_p), "tiered_gather counters differ"
    err = float((rows_k - rows_p).abs().max())
    log(f"B2 tiered_gather: rows and counters bit-exact (near {int(near_k)}, far {int(far_k)})")
    nbytes, nops = tiered_bytes(x, 4, 1)
    b_ms, b_by = bound(nbytes, nops)
    results["tiered_gather"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.tiered_lookup_counted(*args)),
        "plain_ms": time_ms(lambda: ref.tiered_lookup_counted_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bytes": nbytes,
    }
    # B3 gather_rows over the flat f32 mirror, without and with scales
    g = torch.Generator().manual_seed(2)
    flat = torch.randn(1024, x["np"]["d"], generator=g).cuda()
    q = torch.randint(-127, 128, (1024, x["np"]["d"]), generator=g, dtype=torch.int8).cuda()
    ids = x["ids"]
    for src, scales, label in ((flat, None, "f32"), (q, x["cold_scales"], "int8 + scales")):
        out_k = ops.gather_rows(src, ids, scales)
        out_p = ref.gather_rows_ref(src, ids, scales)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p), f"gather_rows differs ({label})"
        log(f"B3 gather_rows {label}: bit-exact")
    err = float((ops.gather_rows(flat, ids) - ref.gather_rows_ref(flat, ids)).abs().max())
    uniq = int(np.unique(x["np"]["ids"]).size)
    nbytes = float(ids.numel() * 4 + uniq * flat.shape[1] * 4 + ids.numel() * flat.shape[1] * 4)
    b_ms, b_by = bound(nbytes, 0.0)
    results["gather_rows"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.gather_rows(flat, ids)),
        "plain_ms": time_ms(lambda: ref.gather_rows_ref(flat, ids)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: flat[ids]),
        "bytes": nbytes,
    }
    for name, r in results.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), library "
            f"{r['library_ms']}")
    return results


def within_one_bf16_step(out, plain) -> bool:
    """Two bf16 roundings of f32 values that differ only in summation order
    differ by at most one bf16 step, 2**-7 of the value."""
    import torch

    a, b = out.float(), plain.float()
    return bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6).all())


def check_attention():
    """B5 and B4 at each served model's widths and types as the model feeds
    them: bf16 for the dense models, f32 queries for zamba2's shared block.

    The kernels and their plain versions both compute in f32 and differ in
    summation order only, so they agree to one bf16 step in bf16 and to
    2e-5 in f32 (the card tests' tolerance). The model's eager
    attention rounds p to bf16 before PV (the kernels, like the TPU
    kernels, do not), so it is held at the JAX tests' bf16 tolerance, 2e-2.
    ``library_ms`` times ``scaled_dot_product_attention``, which the port
    never calls."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import common

    bf = torch.bfloat16
    results = {"flash_attention": {}, "paged_attention": {}}
    for arch, (hq, hkv, d) in ATTN_WIDTHS.items():
        g = torch.Generator().manual_seed(3)
        qdt = torch.float32 if arch in ATTN_F32_Q else bf
        qsz = 4 if qdt == torch.float32 else 2
        rand = lambda *shape, dtype=qdt: torch.randn(*shape, generator=g).to(dtype).cuda()
        close = (lambda a, b: bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5))) if qdt == torch.float32 \
            else within_one_bf16_step
        peak = FP32_OPS_PER_S if qdt == torch.float32 else BF16_OPS_PER_S
        qname = "f32" if qdt == torch.float32 else "bf16"
        # B5: one prompt's prefill; q and k come out of rope contiguous, v
        # is a transposed view of the projection, as the model hands them in
        n = PREFILL_LEN
        q, k = rand(1, hq, n, d), rand(1, hkv, n, d)
        v = rand(1, n, hkv * d).reshape(1, n, hkv, d).transpose(1, 2)
        call = lambda: fa.flash_attention(q, k, v, causal=True, lk_valid=n, q_offset=0)
        out = call()
        plain = fa.flash_attention_ref(q, k, v, causal=True, lk_valid=n, q_offset=0)
        eager = common.attention_chunked(q, k, v, causal=True, block_k=256)
        torch.cuda.synchronize()
        assert close(out, plain), f"flash_attention differs from plain ({arch})"
        torch.testing.assert_close(out.float(), eager.float(), rtol=2e-2, atol=2e-2)
        nbytes = float((2 * q.numel() + 2 * k.numel()) * qsz)  # q and o, k and v
        nops = 4.0 * hq * d * n * (n + 1) / 2  # QK^T and PV over the causal pairs
        b_ms, b_by = bound(nbytes, nops, peak)
        extra = {}
        if qdt == torch.float32:
            # f32-exact products on the tensor cores take TF32_PRODUCTS TF32
            # products each: the least time for this work on them; the CUDA
            # cores' f32 bound stays beside it
            tf32 = fa.flash_attention_tf32_ref(q, k, v, causal=True, lk_valid=n, q_offset=0)
            assert close(out, tf32), f"flash_attention differs from its TF32 algorithm ({arch})"
            extra = {"bound_cuda_cores_ms": b_ms,
                     "err_vs_tf32_algorithm": float((out - tf32).abs().max())}
            b_ms, b_by = bound(nbytes, TF32_PRODUCTS * nops, TF32_OPS_PER_S)
        results["flash_attention"][arch] = {**extra,
            "shapes": f"q (1, {hq}, {n}, {d}), k/v (1, {hkv}, {n}, {d}) {qname}, causal",
            "max_abs_err": float((out.float() - plain.float()).abs().max()),
            "err_vs_eager": float((out.float() - eager.float()).abs().max()),
            "ms": time_ms(call),
            "plain_ms": time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True, lk_valid=n,
                                                               q_offset=0)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
        }
        # B4: one decode step of 8 slots over the engine's per-slot cache,
        # viewed as pages without a copy
        kc, vc = rand(8, hkv, DECODE_S, d, dtype=bf), rand(8, hkv, DECODE_S, d, dtype=bf)
        qd = rand(8, hq, d)
        lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
        kp, vp, table = pa.cache_as_pages(kc, vc, DECODE_PAGE)
        call = lambda: pa.paged_attention(qd, kp, vp, table, lengths)
        out = call()
        plain = pa.paged_attention_ref(qd, kp, vp, table, lengths)
        eager = common.attention_decode(qd[:, :, None], kc, vc, lengths)[:, :, 0]
        torch.cuda.synchronize()
        assert close(out, plain), f"paged_attention differs from plain ({arch})"
        torch.testing.assert_close(out.float(), eager.float(), rtol=2e-2, atol=2e-2)
        seen = sum(min(x, DECODE_S) for x in DECODE_LENGTHS)
        nbytes = float(2 * seen * hkv * d * 2 + 2 * qd.numel() * qsz + table.numel() * 4 + 8 * 4)
        b_ms, b_by = bound(nbytes, 4.0 * hq * d * seen, peak)
        blocks = hkv * 8 * pa.split_count(DECODE_S, hkv, 8)
        log(f"paged_attention [{arch}]: {blocks} blocks of {pa.split_count(DECODE_S, hkv, 8)} a cluster "
            f"({hkv} KV heads x 8 slots x the split), one launch")
        kl, vl = (kc, vc) if qdt == bf else (kc.to(qdt), vc.to(qdt))  # SDPA takes one dtype
        mask = (torch.arange(DECODE_S, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        results["paged_attention"][arch] = {
            "shapes": f"q (8, {hq}, {d}) {qname}, cache (8, {hkv}, {DECODE_S}, {d}) bf16 as pages of "
                      f"{DECODE_PAGE}, lengths {list(DECODE_LENGTHS)}",
            "max_abs_err": float((out.float() - plain.float()).abs().max()),
            "err_vs_eager": float((out.float() - eager.float()).abs().max()),
            "ms": time_ms(call),
            "plain_ms": time_ms(lambda: pa.paged_attention_ref(qd, kp, vp, table, lengths)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kl, vl, attn_mask=mask, enable_gqa=True)),
        }
    for name, per in results.items():
        for arch, r in per.items():
            log(f"{name} [{arch}] {r['shapes']}: max_abs_err vs plain {r['max_abs_err']:.3e} "
                f"(one bf16 step; f32 2e-5), vs eager {r['err_vs_eager']:.3e}; kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{r['bytes'] / 1e6:.2f} MB), library {r['library_ms']:.4f} ms")
            if "bound_cuda_cores_ms" in r:
                log(f"{name} [{arch}]: bound on TF32 tensor cores ({TF32_PRODUCTS} products) "
                    f"{r['bound_ms']:.4f} ms, on the CUDA cores (f32) {r['bound_cuda_cores_ms']:.4f} ms "
                    f"(share {r['bound_cuda_cores_ms'] / r['ms']:.4f}); vs its TF32 algorithm "
                    f"{r['err_vs_tf32_algorithm']:.3e}")
            log(f"{name} [{arch}]: at {r['bound_ms'] / r['ms']:.4f} of its bound; "
                f"{r['ms'] / r['library_ms']:.3f}x the library's time")
    return results


def attention_scaling():
    """Where B5's and B4's time goes, at the dense models' bf16 widths: B5
    causal over prompts of 64 to 1024 (one to 16 key tiles for the longest
    q tile) beside SDPA, and B4 over the decode cache with every length 1
    (the fixed cost: launch, prologue, one chunk and the merges), with the
    main lengths, and with every length 1024; B5 f32 (TF32 tensor cores) at
    zamba2's width over the same prompts; and the floor of this timing, a
    one-element add."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator().manual_seed(5)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16).cuda()
    x = torch.zeros(1, device="cuda")
    log(f"timing floor (one-element add): {time_ms(lambda: x.add_(1)):.4f} ms")
    for arch in ("smollm-360m", "qwen2.5-3b"):
        hq, hkv, d = ATTN_WIDTHS[arch]
        row = []
        for n in (64, 256, 512, 1024):
            q, k = rand(1, hq, n, d), rand(1, hkv, n, d)
            v = rand(1, n, hkv * d).reshape(1, n, hkv, d).transpose(1, 2)
            t = time_ms(lambda: fa.flash_attention(q, k, v, causal=True, lk_valid=n, q_offset=0))
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
            row.append(f"L {n}: {t:.4f} (SDPA {lib:.4f})")
        log(f"flash_attention [{arch}] causal prompts, ms: " + "; ".join(row))
        kc, vc, qd = rand(8, hkv, DECODE_S, d), rand(8, hkv, DECODE_S, d), rand(8, hq, d)
        kp, vp, table = pa.cache_as_pages(kc, vc, DECODE_PAGE)
        row = []
        for label, lens in (("all 1", [1] * 8), ("main", list(DECODE_LENGTHS)), ("all 1024", [1024] * 8)):
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            row.append(f"{label}: {time_ms(lambda: pa.paged_attention(qd, kp, vp, table, lengths)):.4f}")
        log(f"paged_attention [{arch}] 8 slots over S = {DECODE_S}, lengths, ms: " + "; ".join(row))
    hq, hkv, d = ATTN_WIDTHS["zamba2-1.2b"]
    row = []
    for n in (64, 256, 512, 1024):
        q, k = (torch.randn(1, h, n, d, generator=g).cuda() for h in (hq, hkv))
        v = torch.randn(1, n, hkv * d, generator=g).cuda().reshape(1, n, hkv, d).transpose(1, 2)
        t = time_ms(lambda: fa.flash_attention(q, k, v, causal=True, lk_valid=n, q_offset=0))
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        row.append(f"L {n}: {t:.4f} (SDPA {lib:.4f})")
    log("flash_attention [zamba2-1.2b] f32 causal prompts, ms: " + "; ".join(row))


SCAN_CHUNK = 32  # the scan kernels' chunk (kC in csrc/wkv6.cu and csrc/ssd.cu)
SCAN_RTOL = 1e-4  # see check_scans


def _chunks(t: int):
    return [min(SCAN_CHUNK, t - c) for c in range(0, t, SCAN_CHUNK)]


def wkv6_work(b: int, t: int, h: int, hd: int, with_state: bool):
    """(bytes, f32 operations) of one WKV6 call: r, k, v, lw read and y
    written once, u, the state written (and read when given); the
    operations those of the kernel's chunked form on these shapes, an exp
    counted as one: per chunk of n tokens the cumulative sums, the n(n-1)/2
    off-diagonal A terms of hd (sub, exp, mul, fma) and the n diagonal
    ones, the decayed r and k, y = A v + r~ S and the state update."""
    nbytes = 4.0 * (5 * b * t * h * hd + h * hd + (2 if with_state else 1) * b * h * hd * hd)
    ops = 0.0
    for n in _chunks(t):
        ops += (n + 1) * hd + n * (n - 1) / 2 * hd * 5 + n * hd * 3 + n * hd * 5
        ops += n * (n + 1) / 2 * hd * 2 + n * hd * hd * 2 + hd * hd * (1 + 2 * n)
    return nbytes, ops * b * h


def ssd_work(b: int, t: int, h: int, p: int, n_state: int, with_state: bool):
    """(bytes, f32 operations) of one SSD call: x read and y written once,
    dt, B, C, A, D read, the state written (and read when given); the
    operations the function needs in the chunked form, an exp counted as
    one. Per chunk of n tokens: the Gram matrix C B^T over its n(n+1)/2
    causal pairs once, shared by the heads; per head the decays (dt A, its
    cumulative sum and their exps), the n(n+1)/2 segment weights G and their
    product with the Gram matrix, ((C B^T) o G) x, C S_in^T scaled and plus
    D x, x o w once, and the state update exp(.) S_in + (x o w)^T B. (The
    kernel, as the TPU kernel, forms the Gram matrix in every head and
    multiplies x by w again inside its N loop; that redundant work is not
    counted.)"""
    nbytes = 4.0 * (2 * b * t * h * p + b * t * h + 2 * b * t * n_state + 2 * h
                    + (2 if with_state else 1) * b * h * p * n_state)
    ops = 0.0
    for n in _chunks(t):
        tri = n * (n + 1) / 2
        per_head = (6 * n + 4 * tri + 2 * tri * p + 2 * n * p * n_state + 4 * n * p
                    + n * p + p * n_state * (2 * n + 1))
        ops += 2 * n_state * tri + h * per_head
    return nbytes, ops * b


def check_scans():
    """B6 (WKV6) and B7 (SSD) at the served models' widths, f32 as the
    models feed them: rwkv6-7b's 64 heads of 64, zamba2-1.2b's 64 heads of
    P = N = 64; a prompt of 512 from a zero and from a random state, and a
    decode step of 8 slots.

    Decays run from about e^-0.02 to e^-10 a step, so the strong ones are
    there. The kernels take their closed form per chunk of 32 and the plain
    versions the sequential recurrence. The largest gap between the two
    comes from the per-chunk cumulative decay: its sums reach some 300 at
    the strongest decays, where one f32 rounding (3e-5) shifts an
    exponent, and so a term, by a relative 3e-5, over some 64-term dot
    products. Hence the stated tolerance: |kernel - plain| <= 1e-4 of the
    output's largest magnitude plus 1e-4 of each value. ``library_ms`` is
    null: no one PyTorch call computes either scan."""
    import torch

    from repro_torch.kernels import mamba2_scan, rwkv6_scan

    rng = np.random.default_rng(4)
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    normal = lambda *shape: t_(rng.standard_normal(shape))
    h, hd = 64, 64  # heads, and hd = P = N

    def wkv6_case(b, t, state):
        lw = t_(-np.minimum(np.exp(rng.normal(-1.0, 1.5, (b, t, h, hd))), 10.0))
        return (normal(b, t, h, hd), normal(b, t, h, hd), normal(b, t, h, hd), lw, normal(h, hd),
                normal(b, h, hd, hd) if state else None)

    def ssd_case(b, t, state):
        dt = t_(np.log1p(np.exp(rng.normal(0.0, 1.5, (b, t, h)))))
        a = t_(-np.exp(rng.uniform(-2.0, 1.0, h)))  # |dt A| up to ~10
        return (normal(b, t, h, hd), dt, a, normal(b, t, hd), normal(b, t, hd), normal(h),
                normal(b, h, hd, hd) if state else None)

    specs = {
        "wkv6": (rwkv6_scan.wkv6_chunked, rwkv6_scan.wkv6_ref, wkv6_case,
                 lambda b, t, st: wkv6_work(b, t, h, hd, st), "r, k, v, lw"),
        "ssd": (mamba2_scan.ssd_chunked, mamba2_scan.ssd_ref, ssd_case,
                lambda b, t, st: ssd_work(b, t, h, hd, hd, st), "x"),
    }
    shapes = {"prefill": (1, PREFILL_LEN, False), "prefill_state": (1, PREFILL_LEN, True),
              "decode": (8, 1, True)}
    results = {}
    for name, (op, plain, make, work, inputs) in specs.items():
        cases = {label: make(*shape) for label, shape in shapes.items()}
        errs = {}
        for label, args in cases.items():
            out, ref = op(*args), plain(*args)
            torch.cuda.synchronize()
            for a, b_ in zip(out, ref):  # y, then the final state
                torch.testing.assert_close(a, b_, rtol=SCAN_RTOL, atol=SCAN_RTOL * float(b_.abs().max()),
                                           msg=f"{name} {label}")
            errs[label] = max(float((a - b_).abs().max()) for a, b_ in zip(out, ref))
        log(f"{name}: max_abs_err vs plain {errs} (tolerance rtol {SCAN_RTOL}, atol {SCAN_RTOL} x max|plain|)")
        if name == "ssd":
            from repro_torch.kernels.mamba2_scan import ops as scan_ops

            split = mamba2_scan.split_count(PREFILL_LEN, 1, h)
            fit = scan_ops.max_active_clusters(hd, hd, split)
        else:
            from repro_torch.kernels.rwkv6_scan import ops as scan_ops

            split = rwkv6_scan.split_count(PREFILL_LEN, 1, h)
            fit = scan_ops.max_active_clusters(hd, split)
        log(f"{name} prefill: each (b, h) split over a cluster of {split} blocks ({h * split} blocks, "
            f"one launch); {fit} such clusters resident at once")
        assert fit >= h, (name, split, fit)  # one wave
        res = {}
        for label in ("prefill", "decode"):
            args = cases[label]
            b, t = args[0].shape[:2]
            given = args[-1] is not None
            nbytes, nops = work(b, t, given)
            b_ms, b_by = bound(nbytes, nops)
            res[label] = {
                "shapes": f"{inputs} ({b}, {t}, {h}, {hd}) f32, state {'given' if given else 'zero'}",
                "max_abs_err": max(errs.values()),
                "ms": time_ms(lambda: op(*args)),
                "plain_ms": time_ms(lambda: plain(*args), reps=20 if t > 1 else 60),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bytes": nbytes, "ops": nops,
            }
            rr = res[label]
            log(f"{name} {label} {rr['shapes']}: kernel {rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, "
                f"bound {rr['bound_ms']:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} GFLOP), "
                f"library none")
        results[name] = {**res["prefill"], "decode": res["decode"]}
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving engine


def web1_requests(cfg, n: int, seed: int):
    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator

    gen = RequestGenerator(get_profile("Web1"), vocab_size=cfg.vocab_size, seed=seed)
    return [next(gen) for _ in range(n)]


def make_engine(api, params, **ecfg):
    """A serving engine on the card with a cold near tier: a placement push
    puts the near set on the highest page ids, which the allocator hands out
    last, so the run starts with its pages far and the TPP epochs must
    promote the hot ones (at 16 requests the lowest 307 pages, the default
    initial near set, would hold every page the run maps)."""
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    eng = ServingEngine(api, params, EngineConfig(**ecfg), seed=0, device="cuda")
    cap = eng.placement.near_capacity
    eng.apply_placement(np.arange(eng.ecfg.n_pages - cap, eng.ecfg.n_pages))
    return eng


def drive(eng, reqs, step_events: bool = False, quiet_check: bool = False) -> dict:
    """Submit ``reqs`` and step until every one finishes. Returns a dict:
    the per-step next tokens on the host ("toks"), the wall seconds, the
    device ms between step ends ("step_ms"), each request's token stream
    ("streams": the slot's next token after each step it is active and not
    mid-prompt, as ``tests/test_torch_continuous_batching.py`` reads them)
    and the step at whose end its first token existed ("first"). With
    ``quiet_check`` every step that does not drain the counter plane runs
    under ``torch.cuda.set_sync_debug_mode("warn")``, and "quiet" holds
    their count, the host reads they made and the sync warnings they drew
    (a whole-slot step that admits reads its first token back, and is not
    checked either)."""
    import torch

    from repro_torch.device import HOST_READS

    snaps, mid = [], []
    orig = eng._admit

    def admit():
        orig()
        snaps.append({i: s.seq_id for i, s in enumerate(eng.slots) if s.active})

    eng._admit = admit
    for r in reqs:
        eng.submit(r)
    toks, events = [], []
    quiet, reads = 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if step_events:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        while eng.queue or any(s.active for s in eng.slots):
            drains = (eng.engine_steps + 1) % eng.ecfg.placement_window == 0
            admits = not eng.chunking and eng.queue and any(not s.active for s in eng.slots)
            check = quiet_check and not drains and not admits
            reads0 = HOST_READS["copies"]
            torch.cuda.set_sync_debug_mode("warn" if check else 0)
            eng.step()
            torch.cuda.set_sync_debug_mode(0)
            if check:
                quiet += 1
                reads += HOST_READS["copies"] - reads0
            mid.append({i for i, s in enumerate(eng.slots) if s.prefilling})
            toks.append(eng.next_tokens.clone())
            if step_events:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            assert eng.engine_steps < 5000, "engine did not drain"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._admit
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    host = torch.stack(toks).cpu()
    streams, first = {}, {}
    for j, (snap, busy) in enumerate(zip(snaps, mid)):
        for i, sid in snap.items():
            if i not in busy:
                streams.setdefault(sid, []).append(int(host[j, i]))
                first.setdefault(sid, j)
    return {"toks": host, "wall": wall, "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
            "events": events, "streams": streams, "first": first,
            "quiet": {"steps": quiet, "reads": reads, "syncs": syncs}}


def path_launches(eng, eager: dict) -> dict:
    """A path's kernel launches: the wrappers' own counts (eager launches)
    plus the engine's graph replays times the launches each graph holds
    (the wrappers count a capture once, not its replays)."""
    replayed = eng.graph_launches()
    return {k: eager[k] + replayed[k] for k in eager}


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def serve(card: str, arch: str, n_requests: int, widths: tuple, ssm=None):
    """The main path on one model at full width: an engine answering
    ``n_requests`` Web1 requests, every kernel launch counted. ``widths``:
    (layers, d_model, heads, KV heads, d_ff, vocab); ``ssm``: (ssm_head_dim,
    ssm_state, shared_attn_every) of a recurrent family."""
    import torch

    import repro_torch.runtime.tiered_kv as tiered_kv_mod
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model, kernel_launches

    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == widths, cfg
    assert ssm is None or (cfg.ssm_head_dim, cfg.ssm_state, cfg.shared_attn_every) == ssm, cfg
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(seed=0, device="cuda")
    log(f"{arch} params: {sum(p.numel() for p in params.parameters()) / 1e6:.1f} M "
        f"({cfg.param_dtype} stored, {cfg.compute_dtype} compute), init {time.perf_counter() - t0:.1f} s")
    reqs = web1_requests(cfg, n_requests, seed=0)

    # device span of the tiered lookup op in each step: CUDA events around
    # the store's call, read after the run (no sync inside the loop)
    spans = []
    orig = tiered_kv_mod.tiered_lookup_segments

    def timed(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(*a, **k)
        e.record()
        spans.append((s, e))
        return out

    eng = make_engine(api, params, **ECFG)
    tiered_kv_mod.tiered_lookup_segments = timed
    zero_launch_counts()
    try:
        run = drive(eng, reqs, step_events=True)
    finally:
        tiered_kv_mod.tiered_lookup_segments = orig
    wall, step_ms = run["wall"], run["step_ms"]
    eager = launch_counts()
    launches = path_launches(eng, eager)
    st = eng.stats()
    dev = st["device_tiering"]
    decodes = eng.model_dispatches - eng.prefill_dispatches
    graph = eng._graphs["decode"]
    log(f"{arch} main path launches: {launches} (eager {eager}; the decode graph holds "
        f"{graph.launches}, replayed {graph.replays} times), engine steps {eng.engine_steps}, "
        f"{eng.prefill_dispatches} prefill and {decodes} decode dispatches")
    assert st["requests_finished"] == len(reqs), st["requests_finished"]
    assert dev["dispatches_per_step"] == 1.0, dev["dispatches_per_step"]
    assert launches["tiered_segmented"] == eng.engine_steps > 0, (launches, eng.engine_steps)
    assert eng.prefill_dispatches > 0 and decodes > 0, (eng.prefill_dispatches, decodes)
    # every decode dispatch is one replay of the captured decode; the
    # prefills run eagerly
    assert graph.replays == decodes == eng.batch_decodes, (graph.replays, decodes)
    want = kernel_launches(cfg, eng.prefill_dispatches, decodes)
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert {k: eager[k] for k in want} == kernel_launches(cfg, eng.prefill_dispatches, 0), eager
    assert dev["near_hits"] > 0 and dev["far_hits"] > 0, dev
    # the logits of one more decode of the final batch, and of one prefill
    cache = {k: v.clone() for k, v in eng.cache.items()}
    logits, _ = api.decode(params, cache, eng.next_tokens[:, None], page_size=ECFG["page_size"])
    pre, _ = api.prefill(params, {"tokens": torch.as_tensor(reqs[0].tokens[None, :64]).cuda()},
                         max_len=64)
    assert logits.shape == (8, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(pre).all())
    gather_ms = [s.elapsed_time(e) for s, e in spans]
    toks_per_s = st["tokens_decoded"] / wall
    log(f"{arch} main path [{card}]: {len(reqs)} requests, {st['tokens_decoded']} tokens decoded, "
        f"{eng.engine_steps} steps, {st['prefill_tokens']} prompt tokens "
        f"({st['prefill_tokens_saved']} shared), {wall:.3f} s wall")
    log(f"{arch} main path [{card}]: {toks_per_s:.1f} tokens/s (decode tokens over the wall time, "
        f"prefill included); step time p50 {pct(step_ms, 50):.3f} ms, p99 {pct(step_ms, 99):.3f} ms "
        f"(device timeline between step ends)" + (f"; {EAGER_BASELINE}" if arch == "smollm-360m" else ""))
    log(f"{arch} main path [{card}]: tiered lookup op per step p50 {pct(gather_ms, 50):.4f} ms, "
        f"p99 {pct(gather_ms, 99):.4f} ms (device span of the op: one kernel, which also writes the hit table)")
    log(f"{arch} main path [{card}]: near {dev['near_hits']} far {dev['far_hits']} "
        f"(near-hit rate {dev['near_hit_rate']:.4f}), dispatches/step {dev['dispatches_per_step']}, "
        f"host syncs/step {dev['host_syncs_per_step']:.4f}, moved rows {dev['moved_rows']}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    budget = decode_budget(api, params, web1_requests(cfg, 4, seed=1), card, arch)
    return {"launches": launches, "api": api, "params": params, "cfg": cfg, "reqs": reqs,
            "streams": run["streams"], "tokens_per_s": toks_per_s, "profile": budget}


def decode_budget(api, params, reqs, card: str, arch: str):
    """Decode-only steps read nothing back: run steps that neither admit nor
    drain with CUDA sync checking on and count the device-to-host reads.
    Then where a decode step's time goes: 6 more steps timed as they run,
    then 6 under the profiler for the device's share (the profiler's own
    host cost inflates the wall time it sees, so the idle share uses the
    former)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import HOST_READS

    eng = make_engine(api, params, **ECFG)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    eng.step()  # admits all four
    reads0, quiet = HOST_READS["copies"], 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        while quiet < 6 and any(s.active for s in eng.slots):
            drains = (eng.engine_steps + 1) % eng.ecfg.placement_window == 0
            torch.cuda.set_sync_debug_mode(0 if drains else "warn")
            eng.step()
            quiet += not drains
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    reads = HOST_READS["copies"] - reads0
    log(f"{arch} decode-only steps: {quiet} steps, {reads} counted host reads, "
        f"{len(syncs)} sync warnings {syncs[:3]}")
    assert quiet == 6 and reads == 0 and not syncs, (quiet, reads, syncs)

    active = sum(s.active for s in eng.slots)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            eng.step()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device-side entries only: a CPU op's self device time repeats its kernels'
    avgs = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in avgs) / 1e3 / 6
    kernels = sum(e.count for e in avgs) / 6
    top = sorted(avgs, key=dev_us, reverse=True)[:6]
    attn_ms = {name: sum(dev_us(e) for e in avgs if key in e.key) / 1e3 / 6
               for name, key in (("paged_attention", "paged_decode_kernel"), ("flash_attention", "fa_"))}
    log(f"{arch} profile [{card}], decode steps of {active} active slots: {step_ms:.2f} ms a step "
        f"unprofiled, device busy {busy_ms:.3f} ms a step (idle share {1 - busy_ms / step_ms:.4f}), "
        f"{kernels:.0f} device kernels a step; top over 6 steps: "
        + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.2f} ms" for e in top))
    log(f"{arch} profile [{card}]: attention kernels' device time a decode step {attn_ms}")
    return {"step_ms": step_ms, "busy_ms": busy_ms, "kernels_per_step": kernels, "attention_ms": attn_ms}


CHUNK = 64  # the chunked phase's prefill-chunk token budget a step


def serve_chunked(card: str, arch: str, mp: dict) -> dict:
    """Continuous batching with chunked prefill on one model at full width:
    phase 3's params and Web1 requests through an engine with
    ``prefill_chunk=CHUNK``. Every request finishes; each step is one model
    dispatch and one tiered dispatch; the steps that do not drain read
    nothing back (under ``torch.cuda.set_sync_debug_mode``); no prefill
    dispatch, and the model kernels launch once a layer (an application of
    zamba2's shared block) a whole-batch decode, all of them from graph
    replays: one a decode step, one a chunk column. Logs TTFT (device
    timeline, from submission to the end of the step that made the first
    token, and in engine steps), tokens/s, step p50/p99 and the share of
    requests whose tokens equal the whole-slot engine's (not asserted: bf16
    flash prefill and per-token decode round differently at full width)."""
    from repro_torch.models.api import kernel_launches

    api, params, cfg, reqs = mp["api"], mp["params"], mp["cfg"], mp["reqs"]
    eng = make_engine(api, params, **ECFG, prefill_chunk=CHUNK)
    assert eng.chunking
    zero_launch_counts()
    run = drive(eng, [dataclasses.replace(r) for r in reqs], step_events=True, quiet_check=True)
    eager = launch_counts()
    launches = path_launches(eng, eager)
    st = eng.stats()
    dev, sv, q = st["device_tiering"], st["serving"], run["quiet"]
    g = eng._graphs
    log(f"{arch} chunked [{card}]: launches {launches} (eager {eager}), {eng.engine_steps} steps, "
        f"{eng.chunk_columns} chunk columns, {g['decode'].replays} decode steps, {q['steps']} steps "
        f"checked: {q['reads']} host reads, {len(q['syncs'])} sync warnings {q['syncs'][:3]}")
    assert st["requests_finished"] == len(reqs), st["requests_finished"]
    assert dev["dispatches_per_step"] == 1.0 and eng.tiered.dispatches == eng.engine_steps, dev
    assert sv["model_dispatches"] == eng.engine_steps and sv["prefill_dispatches"] == 0, sv
    assert q["steps"] > 0 and q["reads"] == 0 and not q["syncs"], q
    assert g["column"].replays == eng.chunk_columns > 0, (g["column"].replays, eng.chunk_columns)
    assert g["decode"].replays + g["column"].replays == eng.batch_decodes, eng.batch_decodes
    want = kernel_launches(cfg, 0, eng.batch_decodes)
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert all(eager[k] == 0 for k in want), eager
    assert launches["tiered_segmented"] == eng.engine_steps, launches
    # TTFT on the device timeline: every request is submitted before the
    # first step, whose start is events[0]
    ev = run["events"]
    ttft_ms = [ev[0].elapsed_time(ev[j + 1]) for j in run["first"].values()]
    ws = mp["streams"]
    same = [run["streams"][rid][1:] == ws[rid] for rid in ws]
    res = {
        "ttft_p50_ms": pct(ttft_ms, 50), "ttft_p99_ms": pct(ttft_ms, 99),
        "ttft_p50_steps": sv["ttft_p50"], "ttft_p99_steps": sv["ttft_p99"],
        "tokens_per_s": st["tokens_decoded"] / run["wall"],
        "step_p50_ms": pct(run["step_ms"], 50), "step_p99_ms": pct(run["step_ms"], 99),
        "steps": eng.engine_steps, "columns": eng.chunk_columns, "wall_s": run["wall"],
        "same_tokens_share": sum(same) / len(same), "launches": launches,
    }
    log(f"{arch} chunked [{card}]: {len(reqs)} requests, {st['tokens_decoded']} tokens decoded, "
        f"{st['prefill_tokens']} prompt tokens in chunks of {CHUNK}, {run['wall']:.3f} s wall; "
        f"TTFT p50 {res['ttft_p50_ms']:.1f} ms, p99 {res['ttft_p99_ms']:.1f} ms (device timeline; "
        f"{res['ttft_p50_steps']:.1f} / {res['ttft_p99_steps']:.1f} steps); {res['tokens_per_s']:.1f} "
        f"tokens/s; step p50 {res['step_p50_ms']:.3f} ms, p99 {res['step_p99_ms']:.3f} ms; "
        f"requests with the whole-slot engine's tokens {sum(same)} of {len(same)}")
    return res


# moe_sort against moe_einsum on one decode step at granite-moe-3b's full
# width: |logits difference| <= SORT_TOL of the largest einsum logit. Both
# compute in bf16 and differ in rounding only: einsum's combine sums a
# token's k expert outputs in f32 and rounds once, sort rounds each weighted
# output and each of the k - 1 adds to bf16, some 8 roundings of up to
# 2**-9 a layer where einsum makes one, carried through 32 layers. The same
# decode on the CPU at granite's d_model, depth, expert count and top-8
# (experts of 32 wide) gave 0.020 and 0.021 of the largest logit over two
# seeds; the tolerance leaves five times that.
SORT_TOL = 0.1


def moe_checks(card: str, mp: dict) -> dict:
    """Phase 3e's checks of the moe family at full width: one decode of 8
    slots (prompts of 64 tokens, prefilled as one batch) through
    ``moe_sort`` held to ``moe_einsum``'s logits within ``SORT_TOL``; and
    the experts' share of a decode step, from one layer's ``moe_ffn`` at
    the decode's shape (8 rows routed as one group) timed alone, times the
    layers, over the step's device busy time (phase 3's profile)."""
    import torch

    from repro_torch.models import moe

    api, params, cfg = mp["api"], mp["params"], mp["cfg"]
    tokens = np.stack([r.tokens[:64] for r in web1_requests(cfg, 8, seed=2)])
    logits, cache = api.prefill(params, {"tokens": torch.as_tensor(tokens).cuda()},
                                max_len=ECFG["max_len"])
    nxt = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
    out = {}
    for disp in ("einsum", "sort"):
        out[disp], _ = moe.decode_step(params, cfg, {k: v.clone() for k, v in cache.items()}, nxt,
                                       page_size=ECFG["page_size"], dispatch=disp)
    le, ls = out["einsum"].float(), out["sort"].float()
    assert bool(torch.isfinite(le).all() and torch.isfinite(ls).all())
    diff, top = float((le - ls).abs().max()), float(le.abs().max())
    same = float((le[..., : cfg.vocab_size].argmax(-1) == ls[..., : cfg.vocab_size].argmax(-1)).float().mean())
    log(f"{cfg.name} moe_sort vs moe_einsum, one decode of 8 slots: max |logits diff| {diff:.4f}, "
        f"largest logit {top:.4f} (ratio {diff / top:.4f}, tolerance {SORT_TOL}); greedy tokens equal "
        f"on {same:.3f} of the rows")
    assert diff <= SORT_TOL * top, (diff, top)
    layer = params.layers[0].tree(torch.bfloat16)
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16).cuda()
    ffn_ms = {disp: time_ms(lambda: moe.moe_ffn(layer, cfg, x, disp)) for disp in ("einsum", "sort")}
    busy = mp["profile"]["busy_ms"]
    share = cfg.n_layers * ffn_ms["einsum"] / busy
    log(f"{cfg.name} profile [{card}]: one layer's moe_ffn at the decode's shape {ffn_ms['einsum']:.4f} ms "
        f"(sort {ffn_ms['sort']:.4f} ms), x {cfg.n_layers} layers = {cfg.n_layers * ffn_ms['einsum']:.3f} ms "
        f"of the step's {busy:.3f} ms device busy: the experts' share {share:.4f}")
    return {"sort_vs_einsum": diff / top, "sort_same_tokens": same, "moe_ffn_ms": ffn_ms,
            "experts_share": share}


def verify_paths(mp, card: str):
    import torch

    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    api, params, cfg = mp["api"], mp["params"], mp["cfg"]
    reqs = web1_requests(cfg, 4, seed=1)
    out = {}

    def run(label, **over):
        eng = make_engine(api, params, **{**ECFG, **over})
        zero_launch_counts()
        ran = drive(eng, [dataclasses.replace(r) for r in reqs])
        toks, wall = ran["toks"], ran["wall"]
        launches = launch_counts()
        st = eng.stats()
        log(f"verify {label}: {eng.engine_steps} steps, launches {launches}, {wall:.2f} s")
        return eng, st, toks, launches

    eng_a, st_a, toks_a, l_a = run("identity scales + tiered_verify",
                                   tiered_identity_scales=True, tiered_verify=True)
    assert st_a["device_tiering"]["max_read_error"] == 0.0, st_a["device_tiering"]["max_read_error"]
    assert l_a["gather_rows"] == eng_a.engine_steps > 0 and l_a["tiered_segmented"] == eng_a.engine_steps
    out["gather_rows"] = l_a["gather_rows"]
    eng_b, st_b, toks_b, l_b = run("per-slot lookup (segmented_lookup=False)",
                                   tiered_identity_scales=True, segmented_lookup=False)
    da, db = st_a["device_tiering"], st_b["device_tiering"]
    assert (db["near_hits"], db["far_hits"]) == (da["near_hits"], da["far_hits"]), (da, db)
    assert l_b["tiered_gather"] > eng_b.engine_steps and l_b["tiered_segmented"] == 0, l_b
    out["tiered_gather"] = l_b["tiered_gather"]
    eng_c, st_c, toks_c, l_c = run("device tiering off", device_tiering=False)
    assert eng_c.live_counters() == eng_a.live_counters(), (eng_c.live_counters(), eng_a.live_counters())
    assert l_c["tiered_segmented"] + l_c["tiered_gather"] + l_c["gather_rows"] == 0, l_c
    log(f"verify [{card}]: max_read_error 0.0; per-slot near/far {db['near_hits']}/{db['far_hits']} "
        f"== segmented; live_counters equal with tiering off: {eng_c.live_counters()}; tokens "
        f"equal a==b {bool(torch.equal(toks_a, toks_b))}, a==c {bool(torch.equal(toks_a, toks_c))}")

    for small, label in reduced_models():
        reduced_on_card_vs_cpu(small, label)
    return out


def reduced_models():
    """Reduced configs the kernels take on the card: attention head_dim 64
    (the attention kernels are built for 64 and 128) and scan widths of 16
    (the reduced ssm_head_dim and ssm_state, as they are)."""
    from repro_torch.configs import get_config

    return [
        # smollm's GQA group of 3: 3 query heads of 64 over 1 KV head
        (dataclasses.replace(get_config("smollm-360m").reduced(), d_model=192, n_heads=3, n_kv_heads=1),
         "smollm (head_dim 64, 3/1 heads; flash + paged)"),
        (get_config("rwkv6-7b").reduced(), "rwkv6 (4 wkv heads of 16; wkv6)"),
        # the shared block's attention at head_dim 64: 2/2 heads over d 128
        (dataclasses.replace(get_config("zamba2-1.2b").reduced(), d_model=128, n_heads=2, n_kv_heads=2),
         "zamba2 (16 SSD heads of 16, N 16, 2/2 attention heads of 64; ssd + flash + paged)"),
    ]


def reduced_on_card_vs_cpu(small, label: str):
    """A reduced model on the card (kernels, under graphs) against the same
    engine on the CPU (plain versions), on the whole-slot path and on the
    chunked path (prefill_chunk 8): prefill logits, books and tokens."""
    import torch

    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.models.api import get_model, kernel_launches
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    sapi = get_model(small)
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    params = {where: sapi.init(seed=0, device=where) for where in ("cuda", "cpu")}
    for chunk in (0, 8):
        res = {}
        for where, sp in params.items():
            e = ServingEngine(sapi, sp, EngineConfig(
                max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
                device_tiering=True, tiered_identity_scales=True, tiered_verify=True,
                prefill_chunk=chunk,
            ), seed=0, device=where)
            gen = RequestGenerator(prof, vocab_size=small.vocab_size, seed=0)
            toks = []
            for _ in range(6):
                e.submit(next(gen))
            zero_launch_counts()
            while e.queue or any(s.active for s in e.slots):
                e.step()
                toks.append(e.next_tokens.cpu().clone())
            launched = path_launches(e, launch_counts())
            want = kernel_launches(small, e.prefill_dispatches, e.batch_decodes)
            if where == "cpu":
                want = dict.fromkeys(want, 0)
            assert {k: launched[k] for k in want} == want, (label, where, chunk, launched, want)
            assert (e.prefill_dispatches == 0) == (chunk > 0) and e.batch_decodes > 0, (label, chunk)
            logits, _ = sapi.prefill(sp, {"tokens": torch.arange(24, device=where)[None]}, max_len=32)
            res[where] = (torch.stack(toks), e.live_counters(), e.stats(), logits.cpu())
        (tg, lg, sg, pg), (tc, lc, sc, pc) = res["cuda"], res["cpu"]
        err = float((pg - pc).abs().max())
        match = float((tg == tc).float().mean())
        assert err < 1e-3, (label, err)  # f32 on both; summation order differs between the two
        assert lg == lc and sg["device_tiering"] == sc["device_tiering"], (label, chunk, lg, lc)
        assert sg["serving"] == sc["serving"], (label, chunk, sg["serving"], sc["serving"])
        # a greedy argmax may flip at a near-tie under the other summation order
        assert match >= 0.9, (label, chunk, match)
        path = f"chunked (prefill_chunk {chunk})" if chunk else "whole-slot"
        log(f"reduced {label}, {path}, on the card vs the CPU (plain versions): prefill logits max "
            f"|diff| {err:.3e}, per-step tokens equal {match:.4f}, live counters and books equal")


# ---------------------------------------------------------------------------
# phase 5: the fleet over the port's engines


# the full-width fleet's engines: the main path's, with trace-driven
# prediction and the prefetch issue window on (trace windows as the chaos
# study's fleet sets them), and a near tier of 5% of the pages. Under the
# tenants' admission SLOs a host holds a few requests at once, whose pages
# a 30% near tier (307 pages) always covers once the AutoTierer has planned:
# no page in use is ever far, and the window would have nothing to promote.
FLEET_ECFG = dict(ECFG, near_frac=0.05, predictor="trace", prefetch_promote=True, trace_window=16,
                  trace_period=32)
# the reduced fleet's engines: build_fleet's defaults with the same options
FLEET_REDUCED_ECFG = dict(max_batch=4, max_len=64, n_pages=512, device_tiering=True, predictor="trace",
                          prefetch_promote=True, trace_window=16, trace_period=32)
# the chaos study's two tenants (benchmarks/chaos_bench.py): profile, the
# study's overrides of it (its reduced-size traffic), arrival rate, and
# queueing SLO in steps; at full width the profiles are served as they are
FLEET_TENANTS = {
    "web": ("Web1", dict(prompt_mean=24, decode_mean=8, prefix_share=0.9, n_prefixes=3), 8.0, 96.0),
    "cache": ("Cache1", dict(prompt_mean=8, decode_mean=6, prefix_share=0.0, n_prefixes=4), 32.0, 12.0),
}
# (kind, vtime, host, duration): the chaos study's crash of host 1 (a
# replacement host joins after 6) and hang of host 0, and host 2 degraded
# over 14-26, a window that holds the AutoTierer's epochs at 16 and 24
FLEET_SCENARIO = [("crash", 6.0, 1, 6.0), ("hang", 10.0, 0, 3.0), ("degrade", 14.0, 2, 12.0)]


def fleet_traffic(vocab: int, n: int, reduced: bool):
    """``n`` requests of the two tenants merged by arrival time: the
    published profiles, or with ``reduced`` the chaos study's overrides."""
    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator, interleave

    gens = []
    for i, (t, (base, over, rate, _slo)) in enumerate(sorted(FLEET_TENANTS.items())):
        prof = dataclasses.replace(get_profile(base), **(over if reduced else {}))
        gens.append(RequestGenerator(prof, vocab_size=vocab, seed=i, rate=rate, tenant=t))
    return interleave(gens, n)


def wire_fleet(api, params, device: str, ecfg: dict, step_hook=None):
    """The objects ``repro_torch.fleet.build_fleet`` wires, over the given
    model: 3 replicas (engine seed = host id), least-loaded routing, the two
    tenants' admission SLOs, the AutoTierer (30% near, an epoch every 8
    units of virtual time), the elastic layer (1 to 4 hosts) and the chaos
    scenario. Returns the router and every replica it ever had (crashed
    and added ones too). ``step_hook(replica, step)`` wraps each engine's
    step."""
    from repro_torch.fleet import (AdmissionController, AutoTierer, ChaosEngine, ElasticFleet,
                                   FaultEvent, FleetRouter, LeastLoadedPolicy, Replica, SLOModel)
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    built = []

    def make_replica(rid: int) -> Replica:
        eng = ServingEngine(api, params, EngineConfig(**ecfg), seed=rid, device=device)
        r = Replica(rid, eng, 128)
        if step_hook is not None:
            eng.step = step_hook(r, eng.step)
        built.append(r)
        return r

    replicas = [make_replica(i) for i in range(3)]
    slos = {t: SLOModel(max_delay_steps=v[3]) for t, v in FLEET_TENANTS.items()}
    router = FleetRouter(replicas, LeastLoadedPolicy(),
                         admission=AdmissionController(SLOModel(max_delay_steps=64.0), tenant_slos=slos))
    router.autotierer = AutoTierer(replicas, near_frac=0.30, epoch_steps=8)
    router.on_step.append(router.autotierer)
    router.elastic = ElasticFleet(router, make_replica, autotierer=router.autotierer, min_replicas=1,
                                  max_replicas=4)
    router.on_step.append(router.elastic)
    ChaosEngine(router, [FaultEvent(t, kind, rid=rid, duration=d) for kind, t, rid, d in FLEET_SCENARIO],
                dispatch_timeout=8.0, max_retries=3)
    return router, built


def _plain(x):
    """Plain Python values: dataclasses as dicts, arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _plain({f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def fleet_books(router) -> dict:
    """What a fleet run must reproduce wherever it runs (no wall clock
    enters any of it)."""
    return {"log": [list(e) for e in router.chaos.log], "outcome": _plain(router.outcome_report()),
            "fleet_stats": _plain(router.fleet_stats())}


def serve_fleet(card: str, api, params, cfg, device: str = "cuda", n_requests: int = 48) -> dict:
    """The fleet at full width: ``wire_fleet`` over the main path's engines
    and smollm-360m params (shared by every replica, with their held casts),
    through the crash, hang and degrade scenario. Asserts, with every
    engine step watched: one tiered dispatch a step on every replica; no
    host read and no sync warning in a step that neither drains nor admits
    (a whole-slot admission reads its first token back); zero near hits on
    the degraded host inside its window and the pushes there rejected as
    ``degraded``; pages promoted by the prefetch window; every fault
    applied as scheduled; every offered request completed, failed or shed;
    and each replica's model kernels launched once a layer per prefill and
    per whole-batch decode (its eager launches plus its graphs' captured
    launches times their replays)."""
    import torch

    from repro_torch.device import HOST_READS
    from repro_torch.models.api import kernel_launches

    cuda = device == "cuda"
    books = {}

    def step_hook(r, step):
        b = books[r.rid] = {"eager": dict.fromkeys(launch_counts(), 0), "quiet": 0, "reads": 0,
                            "degraded_steps": 0, "degraded_near_pages": 0}
        eng = r.engine

        def watched():
            quiet = ((eng.engine_steps + 1) % eng.ecfg.placement_window != 0
                     and not (eng.queue and any(not s.active for s in eng.slots)))
            before, reads0 = launch_counts(), HOST_READS["copies"]
            if quiet and cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = step()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
            after = launch_counts()
            for k in after:
                b["eager"][k] += after[k] - before[k]
            b["quiet"] += quiet
            b["reads"] += (HOST_READS["copies"] - reads0) if quiet else 0
            if eng.degraded:
                b["degraded_steps"] += 1
                b["degraded_near_pages"] += int((eng.placement.tier == 0).sum()) + eng.tiered.near_count
            return out

        return watched

    router, built = wire_fleet(api, params, device, FLEET_ECFG, step_hook)
    # the degraded host's window: its books at entry (enter_degraded drains
    # first) and at exit (drained here, just before the recovery)
    victim = built[2].engine
    window = {}
    enter, leave = victim.enter_degraded, victim.exit_degraded

    def entered(**k):
        out = enter(**k)
        window["enter"] = (victim.placement.stats.near_hits, victim.placement.stats.far_hits)
        return out

    def left(**k):
        victim.drain_tier_counters()
        window["leave"] = (victim.placement.stats.near_hits, victim.placement.stats.far_hits)
        return leave(**k)

    victim.enter_degraded, victim.exit_degraded = entered, left
    reqs = fleet_traffic(cfg.vocab_size, n_requests, reduced=False)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stats = router.run(iter(reqs), n_requests=n_requests, max_steps=2000, submit_per_step=3)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    rep = router.outcome_report()
    log_ = router.chaos.log
    per = {}
    for r in built:
        eng, b = r.engine, books[r.rid]
        st = eng.stats()
        dev = st["device_tiering"]
        launched = path_launches(eng, b["eager"])
        want = kernel_launches(cfg, eng.prefill_dispatches, eng.batch_decodes)
        if not cuda:
            want = dict.fromkeys(want, 0)
        assert {k: launched[k] for k in want} == want, (r.rid, launched, want)
        assert eng.tiered.dispatches == eng.engine_steps, (r.rid, eng.tiered.dispatches, eng.engine_steps)
        assert launched["tiered_segmented"] == (eng.engine_steps if cuda else 0), (r.rid, launched)
        assert b["reads"] == 0, (r.rid, b)
        per[r.rid] = {"steps": eng.engine_steps, "quiet_steps": b["quiet"], "alive": r.alive,
                      "near_hit_rate": dev["near_hit_rate"], "promoted": st["prefetch_promoted_pages"],
                      "prefill_dispatches": eng.prefill_dispatches, "batch_decodes": eng.batch_decodes,
                      "tokens": st["tokens_decoded"], "launches": launched}
    assert not syncs, syncs[:3]
    # every fault applied at its time, and each recovery at its time + duration
    assert [(t, a, rid) for t, a, rid, ok in log_ if "recover" not in a] == [
        (t, kind, rid) for kind, t, rid, _ in FLEET_SCENARIO], log_
    assert [(t, a) for t, a, _, ok in log_ if ok and "recover" in a] == [
        (t + d, f"{kind}_recover") for kind, t, _, d in sorted(FLEET_SCENARIO, key=lambda f: f[1] + f[3])], log_
    assert all(ok for *_, ok in log_), log_
    # the degraded host: no near page and no near hit inside its window
    vb = books[2]
    near_in = window["leave"][0] - window["enter"][0]
    far_in = window["leave"][1] - window["enter"][1]
    rejected = victim.metrics.snapshot().flat().get("placement_rejected{reason=degraded,replica=2}", 0)
    assert vb["degraded_steps"] > 0 and vb["degraded_near_pages"] == 0 and near_in == 0 and far_in > 0, (
        vb, window)
    assert rejected > 0, victim.metrics.snapshot().flat()
    promoted = sum(p["promoted"] for p in per.values())
    assert promoted > 0, per
    outs = rep["outcomes"]
    assert rep["complete"] and rep["offered"] == n_requests == sum(outs.values()), rep
    assert outs.get("completed", 0) == stats["requests_finished"], (outs, stats["requests_finished"])
    scale = [(e.vtime, e.action, e.rid) for e in router.elastic.events]
    quiet = sum(b["quiet"] for b in books.values())
    log(f"fleet [{card}]: {n_requests} requests over {len(built)} hosts, {wall:.2f} s wall, "
        f"{stats['tokens_decoded']} tokens decoded ({stats['tokens_decoded'] / wall:.1f} tokens/s), "
        f"virtual time {stats['virtual_time']}, outcomes {outs}, failovers {stats['failovers']}, "
        f"lost tokens {stats['lost_tokens']}, fleet near-hit rate {stats['near_hit_rate']:.4f}")
    log(f"fleet [{card}]: chaos log {log_}; elastic events {scale}")
    log(f"fleet [{card}]: degraded host 2: {vb['degraded_steps']} steps in its window, near/far hits "
        f"there {near_in}/{far_in}, {rejected} pushes rejected as degraded; {quiet} quiet steps "
        f"checked: 0 host reads, 0 sync warnings; prefetch window promoted {promoted} pages")
    for rid, p in per.items():
        log(f"fleet [{card}] host {rid}: " + json.dumps({k: v for k, v in p.items() if k != "launches"})
            + f" launches {p['launches']}")
    launches = {k: sum(p["launches"][k] for p in per.values()) for k in launch_counts()}
    return {"wall_s": wall, "tokens": stats["tokens_decoded"], "promoted": promoted, "per_host": per,
            "launches": launches, "books": fleet_books(router)}


def reduced_fleet_card_vs_cpu(card: str):
    """The same wiring over the reduced head_dim-64 smollm (the first of
    ``reduced_models``), at build_fleet's engine sizes and the chaos study's
    traffic, on the card and on the CPU: the chaos log, outcome ledger and
    fleet_stats (per-replica books included) are equal, since a fleet's
    books follow its schedule, not its token values."""
    from repro_torch.models.api import get_model

    small, _label = reduced_models()[0]
    sapi = get_model(small)
    res = {}
    for where in ("cuda", "cpu"):
        router, _ = wire_fleet(sapi, sapi.init(seed=0, device=where), where, FLEET_REDUCED_ECFG)
        router.run(iter(fleet_traffic(small.vocab_size, 24, reduced=True)), n_requests=24, max_steps=600,
                   submit_per_step=3)
        res[where] = fleet_books(router)
    same = {k: res["cuda"][k] == res["cpu"][k] for k in res["cuda"]}
    log(f"reduced fleet on the card vs the CPU: {same}; outcomes {res['cuda']['outcome']['outcomes']}, "
        f"promoted {sum(p['prefetch_promoted_pages'] for p in res['cuda']['fleet_stats']['per_replica'])}")
    assert all(same.values()), same
    return res


# ---------------------------------------------------------------------------
# phase 7: the sharded engine on one card


SHARDS = (1, 2, 4)
# the books a split store counts per shard and not per logical lookup
SHARD_BUDGET_KEYS = ("lookups", "dispatches", "host_syncs", "drains", "dispatches_per_step",
                     "host_syncs_per_step", "shards", "shard_near_capacity", "shard_dispatches",
                     "shard_near_hits", "shard_far_hits")


def serve_sharded(card: str, mp: dict) -> dict:
    """Phase 3's smollm-360m params and 16 Web1 requests through the main
    path's engine with its tiered store split into 1, 2 and 4
    page-interleaved shards (``ServingEngine`` with ``model_shards``; the
    parameters stay whole on the card). Asserts: tokens bit-identical at
    every count; the merged drained near/far counts and slot, tenant and
    role planes, the live counters and the books equal; the shard-labeled
    counter rows sum to the totals; each step's lookup launches B1 once per
    non-empty shard (at most N); every request finishes; no host read in a
    step that neither drains nor admits; each drain reads back once per
    dirty shard; and the model kernels once a layer a prefill and a decode."""
    import torch

    from repro_torch.device import HOST_READS
    from repro_torch.kernels import tiered_gather
    from repro_torch.models.api import kernel_launches

    api, params, cfg, reqs = mp["api"], mp["params"], mp["cfg"], mp["reqs"]
    runs = {}
    for n in SHARDS:
        eng = make_engine(api, params, **ECFG, model_shards=n)
        store = eng.tiered
        shards = getattr(store, "shards", [store])
        assert len(shards) == n and (type(eng).__name__ == "ShardedServingEngine") == (n > 1)
        lookups, drains = [], []
        merged = {"near": 0, "far": 0, "slot": np.zeros((0, 2), np.int64),
                  "tenant": np.zeros((0, 2), np.int64), "role": 0}

        def lookup(ids, *a, _orig=store.lookup_segments, **k):
            busy = np.unique(np.asarray(ids, np.int64) % n).size
            before = tiered_gather.LAUNCHES["tiered_segmented"]
            out = _orig(ids, *a, **k)
            lookups.append((busy, tiered_gather.LAUNCHES["tiered_segmented"] - before))
            return out

        def drain(discard=False, _orig=store.drain_counters):
            dirty = sum(sh._plane_dirty for sh in shards)
            reads0 = HOST_READS["copies"]
            d = _orig(discard=discard)
            drains.append((dirty, HOST_READS["copies"] - reads0))
            merged["near"] += d["near"]
            merged["far"] += d["far"]
            merged["role"] = merged["role"] + np.asarray(d["role"], np.int64)
            for plane in ("slot", "tenant"):
                a, b = merged[plane], np.asarray(d[plane], np.int64)
                k = max(a.shape[0], b.shape[0])
                merged[plane] = np.pad(a, ((0, k - a.shape[0]), (0, 0))) + np.pad(b, ((0, k - b.shape[0]), (0, 0)))
            return d

        store.lookup_segments, store.drain_counters = lookup, drain
        zero_launch_counts()
        run = drive(eng, [dataclasses.replace(r) for r in reqs], quiet_check=True)
        launches = path_launches(eng, launch_counts())
        st = eng.stats()
        dev, q = st["device_tiering"], run["quiet"]
        decodes = eng.model_dispatches - eng.prefill_dispatches
        want = kernel_launches(cfg, eng.prefill_dispatches, decodes)
        assert {k: launches[k] for k in want} == want, (n, launches, want)
        assert st["requests_finished"] == len(reqs), (n, st["requests_finished"])
        assert q["steps"] > 0 and q["reads"] == 0 and not q["syncs"], (n, q)
        assert all(b == l and 1 <= b <= n for b, l in lookups), (n, lookups)
        assert launches["tiered_segmented"] == sum(l for _, l in lookups) == dev["dispatches"], (n, launches)
        assert drains and all(d == r for d, r in drains), (n, drains)
        if n > 1:
            assert sum(dev["shard_near_hits"]) == dev["near_hits"] > 0, dev
            assert sum(dev["shard_far_hits"]) == dev["far_hits"] > 0, dev
            assert eng.metrics.total("shard_near_hits") == dev["near_hits"], dev
            assert eng.metrics.total("shard_far_hits") == dev["far_hits"], dev
        busy = [b for b, _ in lookups]
        runs[n] = {"toks": run["toks"], "merged": merged, "live": eng.live_counters(), "role": eng.role_hits,
                   "books": {**st, "device_tiering": {k: v for k, v in dev.items() if k not in SHARD_BUDGET_KEYS}},
                   "launches": launches["tiered_segmented"], "steps": eng.engine_steps, "wall": run["wall"],
                   "busy": {b: busy.count(b) for b in sorted(set(busy))}, "drains": len(drains),
                   "drain_reads": sum(r for _, r in drains), "quiet": q["steps"],
                   "shard_hits": (dev.get("shard_near_hits"), dev.get("shard_far_hits"))}
        log(f"sharded [{card}] model_shards {n}: {eng.engine_steps} steps, B1 launches {runs[n]['launches']} "
            f"(lookups by non-empty shards {runs[n]['busy']}), {len(drains)} drains reading back "
            f"{runs[n]['drain_reads']} times (one a dirty shard), {q['steps']} quiet steps with 0 host reads; "
            f"near {dev['near_hits']} far {dev['far_hits']}, per shard {runs[n]['shard_hits']}; "
            f"{run['wall']:.3f} s wall")
    one = runs[SHARDS[0]]
    for n in SHARDS[1:]:
        r = runs[n]
        assert torch.equal(r["toks"], one["toks"]), n
        assert r["live"] == one["live"] and r["books"] == one["books"], n
        assert np.array_equal(r["role"], one["role"]), n
        m1, mn = one["merged"], r["merged"]
        assert (mn["near"], mn["far"]) == (m1["near"], m1["far"]) and np.array_equal(mn["role"], m1["role"]), n
        for plane in ("slot", "tenant"):
            k = max(m1[plane].shape[0], mn[plane].shape[0])
            pad = lambda a: np.pad(a, ((0, k - a.shape[0]), (0, 0)))
            assert np.array_equal(pad(m1[plane]), pad(mn[plane])), (n, plane)
    log(f"sharded [{card}]: model_shards {list(SHARDS)} give bit-identical tokens "
        f"({one['toks'].shape[0]} steps x {one['toks'].shape[1]} slots), equal live counters, books and "
        f"merged drained planes (near {one['merged']['near']}, far {one['merged']['far']})")
    return {str(n): {k: v for k, v in r.items() if k not in ("toks", "merged", "live", "role", "books")}
            for n, r in runs.items()}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: the port's package is not at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # phase 1: device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        report = lib.with_name(lib.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas: {line.strip()}")
    sass_counts(libs["flash_attention"])
    log(f"phase 1 {time.perf_counter() - t_start:.1f} s")

    # phase 2: kernels against their plain versions
    kernels = check_kernels()
    attention = check_attention()
    attention_scaling()
    kernels.update(check_scans())
    t2 = time.perf_counter()
    log(f"phase 2 {t2 - t_start:.1f} s")
    # phase 3: the main path (whole-slot, decode graphs), smollm-360m; 3b:
    # qwen2.5-3b; 3c: rwkv6-7b; 3d: zamba2-1.2b; 3e: granite-moe-3b (with
    # its moe checks); each followed (3x) by the chunked path on the same
    # params and requests
    paths, chunked, moe_res = {}, {}, {}
    for arch, n_req, widths, ssm in (
        ("smollm-360m", 16, (32, 960, 15, 5, 2560, 49152), None),
        ("qwen2.5-3b", 6, (36, 2048, 16, 2, 11008, 151936), None),
        ("rwkv6-7b", 6, (32, 4096, 64, 64, 14336, 65536), (64, 0, 0)),
        ("zamba2-1.2b", 8, (38, 2048, 32, 32, 8192, 32000), (64, 64, 6)),
        ("granite-moe-3b-a800m", 6, (32, 1536, 24, 8, 512, 49155), None),
    ):
        t3 = time.perf_counter()
        paths[arch] = serve(card, arch, n_req, widths, ssm)
        t3x = time.perf_counter()
        log(f"phase 3 {arch} {t3x - t3:.1f} s")
        chunked[arch] = serve_chunked(card, arch, paths[arch])
        log(f"phase 3x {arch} chunked {time.perf_counter() - t3x:.1f} s")
        if paths[arch]["cfg"].family == "moe":
            t3e = time.perf_counter()
            moe_res[arch] = moe_checks(card, paths[arch])
            log(f"phase 3e {arch} moe checks {time.perf_counter() - t3e:.1f} s")
        if arch != "smollm-360m":
            del paths[arch]["params"], paths[arch]["api"]
            torch.cuda.empty_cache()
    mp = paths["smollm-360m"]
    log(f"phase 3 smollm-360m to granite-moe-3b {time.perf_counter() - t2:.1f} s")
    log("chunked paths: " + "; ".join(
        f"{arch} " + json.dumps({k: v for k, v in c.items() if k != "launches"})
        for arch, c in chunked.items()))
    # phase 4: the verify paths
    t4 = time.perf_counter()
    vp = verify_paths(mp, card)
    log(f"phase 4 {time.perf_counter() - t4:.1f} s")

    # phase 5: the fleet at full width over smollm-360m's params, then the
    # reduced fleet on the card against the CPU
    t5 = time.perf_counter()
    fleet = serve_fleet(card, mp["api"], mp["params"], mp["cfg"])
    t5r = time.perf_counter()
    log(f"phase 5 fleet {t5r - t5:.1f} s")
    reduced_fleet_card_vs_cpu(card)
    log(f"phase 5r reduced fleet {time.perf_counter() - t5r:.1f} s")

    # phase 7: the sharded engine over smollm-360m's params, 1, 2 and 4 shards
    t7 = time.perf_counter()
    sharded = serve_sharded(card, mp)
    log(f"phase 7 sharded {time.perf_counter() - t7:.1f} s")

    # phase 6: summary. Each row's launches are those of the main path that
    # runs it; the attention rows carry smollm-360m's numbers, and the other
    # models' ride along
    # chunked_launches: the same kernels' launches on that model's chunked path;
    # fleet_launches: on the fleet's path, summed over its hosts;
    # sharded_launches: B1's on phase 7's path at each shard count
    carrier = {"tiered_segmented": "smollm-360m", "paged_attention": "smollm-360m",
               "flash_attention": "smollm-360m", "wkv6": "rwkv6-7b", "ssd": "zamba2-1.2b"}
    launches = {"tiered_segmented": mp["launches"]["tiered_segmented"],
                "tiered_gather": vp["tiered_gather"], "gather_rows": vp["gather_rows"],
                "paged_attention": mp["launches"]["paged_attention"],
                "flash_attention": mp["launches"]["flash_attention"],
                "wkv6": paths["rwkv6-7b"]["launches"]["wkv6"],
                "ssd": paths["zamba2-1.2b"]["launches"]["ssd"]}
    for name in ("paged_attention", "flash_attention"):
        per = attention[name]
        kernels[name] = {**per["smollm-360m"], **{arch: {
            **{k: per[arch][k] for k in ("shapes", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")
               if k in per[arch]},
            "launches": paths[arch]["launches"][name]} for arch in MODELS_BESIDE}}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{source}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"chunked_launches": chunked[carrier[name]]["launches"][name]} if name in carrier else {}),
            **({"fleet_launches": fleet["launches"][name]} if carrier.get(name) == "smollm-360m" else {}),
            **({"sharded_launches": {n: v["launches"] for n, v in sharded.items()}}
               if name == "tiered_segmented" else {}),
            **{k: r[k] for k in (*MODELS_BESIDE, "shapes") if k in r},
            **({"decode": {k: v for k, v in r["decode"].items() if k != "bytes"}} if "decode" in r else {}),
        })
    log("decode step profiles: " + "; ".join(f"{arch} {p['profile']}" for arch, p in paths.items()))
    log("moe checks: " + json.dumps(moe_res))
    log("sharded engine: " + json.dumps(sharded))
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
