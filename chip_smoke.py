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
     qwen2.5-3b, granite-moe-3b (24/8 heads of 64), qwen2-vl-7b (28/4
     heads of 128, a GQA group of 7) and whisper-base's decoder (8/8 of
     64), bf16, and zamba2-1.2b, f32 (flash on TF32 tensor cores,
     three products a product): within one bf16 step (2e-5 in f32) of the
     plain version, and within 2e-2 of the model's eager attention;
   - flash attention at whisper-base's three non-causal sites, 8 heads of
     64 over its 1500 frames (23 key tiles of 64 and a ragged one of 28):
     the encoder (1 x 1500 queries, bf16), the cross-attention at prefill
     (a prompt of 512 queries, bf16) and at decode (8 slots x 1 query, f32
     as the model feeds it), the last beside the paged kernel over the
     same bf16 cross cache viewed as pages of 20;
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
   - the training forward's kernels: B5 with its softmax stats at every
     training site (smollm-360m's layers, whisper-base's non-causal
     encoder over 1,500 frames, its cross-attention of 4,096 queries over
     them and its causal decoder, zamba2-1.2b's cast shared block), and B6
     and B7 writing their chunk-entry states at a micro-batch of 2 x 4,096
     tokens: outputs bit-equal to the launches without, stats and states
     within their tolerances of the plain versions, all timed, the scans
     also at a split of 1 and their chunked VJP;
3. the main path: a device-tiered ``ServingEngine`` over full-width
   smollm-360m (32 layers, random weights from a seed, drawn on the card:
   ``draw_on_card``) answering 16 Web1
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
   3f. the same over full-width qwen2-vl-7b (28 layers, d 3584, 28/4 heads
   of 128, qkv bias, M-RoPE sections (16, 24, 24), vocab 152064, untied
   head) on 6 Web1 requests, prefilled from the embedding rows
   with the three M-RoPE channels at the text positions; then one prefill
   with 3-D positions (text, an image block at one t over a 16 x 16 grid,
   text) with finite logits, and one with three equal channels whose
   logits equal the token path's bit for bit;
   3g. the same over full-width whisper-base (6 encoder and 6 decoder
   layers, d 512, 8/8 heads of 64, 1500 audio frames of the front end's
   stub, zeros) on 8 Web1 requests: one flash launch per encoder layer and
   two per decoder layer per prefill, one paged (self) and one flash
   (cross, inside the captured decode) per decoder layer per decode, the
   flash launches counted site by site where they are made;
   3x. after each model's main path, continuous batching with chunked
   prefill on the same params and requests (``prefill_chunk=64``): every
   request finishes, one model and one tiered dispatch a step, no prefill
   dispatch, no host read in any step that does not drain, and the model
   kernels once a layer per whole-batch decode (a decode step, or a chunk
   column, each a graph replay); TTFT, tokens/s, step time, and the share
   of requests whose tokens equal the whole-slot engine's. qwen2-vl-7b and
   whisper-base are not chunkable (as in the reference): with the same
   chunk budget they prefill whole at admission, capture no column graph,
   and give the whole-slot engine's tokens;
4. the verify paths at full width on 4 requests: identity scales with the
   in-line flat-mirror probe (no read error), the per-slot lookup baseline
   (same drained hit totals), device tiering off (same live counters); and
   reduced smollm, rwkv6, zamba2, qwen2-vl and whisper models on the card
   (kernels, graphs) against the same engine on the CPU (plain versions),
   whole-slot and with a chunk budget;
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
   printed last, after phases 7 to 10;
7. the sharded engine on one card: phase 3's smollm-360m params and
   requests with the tiered store split into 1, 2 and 4 page-interleaved
   shards (``model_shards``): bit-identical tokens, equal merged drained
   planes and books, B1 once per non-empty shard a step, no host read in
   a step that neither drains nor admits, one read a dirty shard a drain;
8. training: the loss and gradients of reduced smollm, granite-moe,
   rwkv6, zamba2 and whisper (attention head_dim 64, f32; whisper over
   100 frames) on the card against the CPU; then, through
   ``make_train_step`` with AdamW (clip_norm 1.0) on one fixed batch of
   sequences of 4,096 tokens in 2 micro-batches, remat on, at full width:
   smollm-360m (8 sequences, 5 steps), zamba2-1.2b whole (4, 3 steps),
   whisper-base whole (8 over 8 clips of 1,500 frames, 3 steps) and
   rwkv6-7b cut to 4 of its 32 layers (4, 3 steps). Every attention
   layer's forward runs on B5 with its softmax stats, every rwkv6 layer on
   B6 and every Mamba2 layer on B7 writing their chunk-entry states, each
   as often as remat recomputes it (``train_kernel_launches``); the
   backwards run in plain PyTorch (the reference's attention backward, the
   scans' chunked VJP); no host read inside a step; the loss falls; step
   time, tokens/s, peak memory and the device-busy shares of one profiled
   step. Phase 2 holds these kernels at these shapes to their plain
   versions and times them;
9. the trainer (``runtime.Trainer``, ``checkpoint``, ``data``, the
   launcher), in a child process that runs deterministic algorithms
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in its environment only): full-width
   smollm-360m on SyntheticCorpus sequences of 1,024 tokens, 8 a step
   through ShardedLoader; a trainer that checkpoints every 2 steps crashes
   after step 3, a fresh one restores step 2 and runs to step 4, and every
   parameter and AdamW leaf equals a clean run's bit for bit; B5 launched
   ``train_kernel_launches`` times every step; then
   ``repro_torch.launch.train`` starts fresh and resumes from its own
   checkpoint. Step times, the checkpoint's snapshot, write and restore
   times and its bytes.
10. the launch layer (``repro_torch.launch``): the serving launcher
   (``launch.serve.main``) at full width, smollm-360m on 16 Web1-profile
   requests, every request finished and both tiers read; the op-level
   cost walk (``launch.op_analysis``) of full-width smollm-360m's train step
   (phase 9's 8 x 1,024 tokens) and of a whole-batch decode step (8 slots
   over a 1,024 cache) on the meta device against the same steps on the
   card: the walk's peak live bytes within 0.67-1.5 of the measured rise in
   ``max_memory_allocated``, the measured device time at or above the
   walk's roofline bound, and the kernels the walk recorded equal to the
   launches, kernel by kernel; then the dry run (``launch.dryrun``) of
   smollm-360m's three cells on meta, rendered by ``launch.report``;
11. the sharded engine over a mesh of cards (``launch.mesh``), here of
   this one card (a 1-rank NCCL group): phase 7's smollm-360m params and
   16 requests through ``ShardedServingEngine(mesh=...)``, its parameters
   placed by ``shard_model_params`` and every step run under the mesh,
   eagerly: tokens, live counters, books and role hits bit-equal to phase
   7's 1-shard engine; B1, B4 and B5 launched as on the main path. Then
   one model of each other family, phase 3's full-width params cut to 2
   layers (zamba2-1.2b to 6, one application of its shared block):
   granite-moe-3b-a800m, qwen2-vl-7b, rwkv6-7b, zamba2-1.2b and
   whisper-base, 4 requests each, bit-equal to the same engine without a
   mesh, with B4/B5, B6 or B7 and B1 launched as on the main path.
   ``mesh_phase()`` serves full-width qwen1.5-110b (4 of its 80 layers)
   over meshes of 1, 2 and 4 cards, its chunked path
   (``prefill_chunk=64``) over 2, and full-width qwen2-moe-a2.7b (all 24
   layers, more than one card holds) over 2 and 4; it needs a machine
   with 4 cards and runs alone (``README.md``, "Running the port on the
   GPU"); qwen1.5-110b serves in its shipped config (``sp_activations``);
12. training over a mesh of this one card, in a child process with
   deterministic algorithms: full-width smollm-360m at phase 9's 8 x
   1,024 tokens, its parameters and AdamW moments placed at
   ``core.pooling.pooled_specs`` over a ("data", "pool", "model") mesh of
   one card (``launch.mesh.place_params``): 3 steps of ``make_train_step``
   bit-equal to the same steps without a mesh (metrics, every parameter
   and moment), B5 launched ``train_kernel_launches`` times a step; then a
   ``Trainer`` on the mesh saves and ``elastic_restore`` puts the state
   onto the card without a mesh, bit-equal; then qwen2-vl-7b (2 layers),
   zamba2-1.2b (6) and whisper-base the same way, B5 and B7 launched as
   ``train_kernel_launches`` gives. ``train_mesh_phase()`` trains what no
   card holds over four (qwen1.5-110b, rwkv6-7b, qwen2-moe-a2.7b,
   qwen2-vl-7b at full width, pooled; zamba2-1.2b and whisper-base against
   a step with no mesh; the walk of qwen1.5-110b's step on meta against the
   cards), and runs alone like ``mesh_phase()``. Phase 2 also
   holds B5 with its lse at sequence-parallel rows (a non-zero
   ``q_offset``) to its plain version.

Each path's kernel launch counts are zeroed just before it and read just
after, so the counts show which kernels each path went through. A path's
launches are the wrappers' counts (eager launches: the prefills, the
tiered lookups) plus the engine's graph replays times the launches each
captured graph holds (``ServingEngine.graph_launches``): the wrappers'
counts are Python increments, made once at capture and not at a replay.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

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
               "granite-moe-3b-a800m": (24, 8, 64), "qwen2-vl-7b": (28, 4, 128), "whisper-base": (8, 8, 64)}
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
MODELS_BESIDE = ("qwen2.5-3b", "zamba2-1.2b", "granite-moe-3b-a800m", "qwen2-vl-7b", "whisper-base")
CROSS_PAGE = 20  # whisper's 1500 frames = 75 pages of 20: the cross cache as pages for the paged kernel
# the functions that hold whisper-base's flash sites: the flash launches
# of each are counted on its main path as the rise of the flash wrapper's
# count over that function's calls (see ``flash_site_counts``)
WHISPER_FLASH_SITES = {"encoder": ("repro_torch.models.whisper", "encode"),
                       "self": ("repro_torch.models.attention", "apply_prefill"),
                       "cross": ("repro_torch.models.whisper", "_cross_attend")}
# the main path on smollm-360m with eager attention, as measured at commit
# 0f3184b (NVIDIA H100 80GB HBM3, 700 W)
EAGER_BASELINE = ("eager attention at commit 0f3184b on NVIDIA H100 80GB HBM3, 700 W: "
                  "43.8 tokens/s, step p50 92.6 ms, p99 335.2 ms")


def card_name() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def bound(work):
    """(least time in ms, what bounds it) of a kernel call's ``(bytes,
    operations, peak)`` (``repro_torch/kernels/work.py``) at the card's
    published peaks (``repro_torch/core/hw.py``): ``peak`` is the peak of
    the unit the operations run on."""
    from repro_torch.core import hw

    bytes_moved, ops, ops_per_s = work
    t_bytes, t_ops = bytes_moved / hw.HBM_BW, ops / ops_per_s
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


def tiered_work(x, n_seg: int):
    """B1's or B2's work (``kernels/work.py``) on the f32 store of
    ``kernel_inputs``: what its page ids and tier map need."""
    from repro_torch.kernels import work

    ids, tier = x["np"]["ids"], x["np"]["tier"]
    return work.tiered_lookup(ids.size, x["np"]["d"], 4, n_seg, ids=ids, tier=tier)


def check_kernels():
    import torch

    from repro_torch.kernels import work
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
            w = tiered_work(x, x["n_segments"])
            nbytes = w[0]
            b_ms, b_by = bound(w)
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
    w = tiered_work(x, 1)
    nbytes = w[0]
    b_ms, b_by = bound(w)
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
    w = work.gather_rows(ids.numel(), flat.shape[1], 4, False, ids=x["np"]["ids"])
    nbytes = w[0]
    b_ms, b_by = bound(w)
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


def flash_sites(frames: int) -> list:
    """B5's sites, each (model, site, batch, Lq, Lk, q dtype, causal, where
    k and v come from): every served model's prompt of ``PREFILL_LEN``
    (causal; q and k out of rope contiguous, v a transposed view of the
    projection), and whisper-base's non-causal ones over its ``frames``:
    the encoder (q, k, v transposed projection views; every key valid, the
    last of 24 key tiles 28 rows of TMA's zero fill), the cross-attention
    at prefill (a prompt's queries over the cross K/V, views of their
    projection) and at decode (one f32 query a slot over the bf16 cross
    cache upcast to f32: whisper's decode runs the stored f32 weights, so
    its q comes out f32)."""
    prompts = [(arch, "prompt", 1, PREFILL_LEN, PREFILL_LEN, "f32" if arch in ATTN_F32_Q else "bf16",
                True, "rope") for arch in ATTN_WIDTHS]
    return prompts + [
        ("whisper-base", "encoder", 1, frames, frames, "bf16", False, "projection"),
        ("whisper-base", "cross_prefill", 1, PREFILL_LEN, frames, "bf16", False, "projection"),
        ("whisper-base", "cross_decode", 8, 1, frames, "f32", False, "cache"),
    ]


def log_row(name: str, label: str, r: dict):
    log(f"{name} [{label}] {r['shapes']}: max_abs_err vs plain {r['max_abs_err']:.3e} "
        f"(one bf16 step; f32 2e-5), vs eager {r['err_vs_eager']:.3e}; kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
        f"{r['bytes'] / 1e6:.2f} MB), library {r['library_ms']:.4f} ms")
    if "bound_cuda_cores_ms" in r:
        log(f"{name} [{label}]: bound on TF32 tensor cores (three products) "
            f"{r['bound_ms']:.4f} ms, on the CUDA cores (f32) {r['bound_cuda_cores_ms']:.4f} ms "
            f"(share {r['bound_cuda_cores_ms'] / r['ms']:.4f}); vs its TF32 algorithm "
            f"{r['err_vs_tf32_algorithm']:.3e}")
    log(f"{name} [{label}]: at {r['bound_ms'] / r['ms']:.4f} of its bound; "
        f"{r['ms'] / r['library_ms']:.3f}x the library's time")


def check_flash(q, k, v, causal: bool, shapes: str) -> dict:
    """B5 on one site's inputs: within one bf16 step (2e-5 in f32) of its
    plain version and within 2e-2 of the model's eager attention, then
    timed beside the plain version and SDPA, with its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import hw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import work
    from repro_torch.models import common

    f32 = q.dtype == torch.float32
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    kw = dict(causal=causal, lk_valid=lk, q_offset=0)
    call = lambda: fa.flash_attention(q, k, v, **kw)
    out, plain = call(), fa.flash_attention_ref(q, k, v, **kw)
    eager = common.attention_chunked(q, k, v, causal=causal, block_k=256)
    torch.cuda.synchronize()
    close = (lambda a, b: bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5))) if f32 else within_one_bf16_step
    assert close(out, plain), f"flash_attention differs from plain ({shapes})"
    torch.testing.assert_close(out.float(), eager.float(), rtol=2e-2, atol=2e-2)
    # q, o, k, v; QK^T and PV over the causal pairs (Lq = Lk, q row 0 at
    # position 0) or all of them; f32 as three TF32 products a product
    w = work.flash_attention(b, hq, k.shape[1], lq, lk, d, q.element_size(), causal)
    nbytes = w[0]
    b_ms, b_by = bound(w)
    extra = {}
    if f32:
        # the least time for this work on the TF32 tensor cores above; the
        # CUDA cores' f32 bound stays beside it
        tf32 = fa.flash_attention_tf32_ref(q, k, v, **kw)
        assert close(out, tf32), f"flash_attention differs from its TF32 algorithm ({shapes})"
        extra = {"bound_cuda_cores_ms": bound((w[0], w[1], hw.PEAK_FLOPS_FP32))[0],
                 "err_vs_tf32_algorithm": float((out - tf32).abs().max())}
    return {**extra, "shapes": shapes,
            "max_abs_err": float((out.float() - plain.float()).abs().max()),
            "err_vs_eager": float((out.float() - eager.float()).abs().max()),
            "ms": time_ms(call),
            "plain_ms": time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))}


def paged_over_pages(q, ck, cv) -> dict:
    """A measured alternative to B5 at whisper-base's decode cross-attention:
    the paged kernel (B4) over the bf16 cross cache viewed as pages of
    ``CROSS_PAGE``, no upcast, within 2e-5 of B5 over the upcast cache,
    beside the upcast's own time."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work

    b, _, n, _ = ck.shape
    out = fa.flash_attention(q, ck.float(), cv.float(), causal=False, lk_valid=n, q_offset=0)[:, :, 0]
    assert n % CROSS_PAGE == 0, (n, CROSS_PAGE)
    qd = q[:, :, 0]
    kp, vp, table = pa.cache_as_pages(ck, cv, CROSS_PAGE)
    lengths = torch.full((b,), n, dtype=torch.int32, device="cuda")
    paged = lambda: pa.paged_attention(qd, kp, vp, table, lengths)
    po = paged()
    torch.cuda.synchronize()
    assert torch.allclose(po, out, rtol=2e-5, atol=2e-5), "paged over the cross cache differs"
    w = work.paged_attention(b, q.shape[1], ck.shape[1], q.shape[3], 4, 2, n // CROSS_PAGE, CROSS_PAGE,
                             lengths=[n] * b)
    r = {"upcast_ms": time_ms(lambda: (ck.float(), cv.float())),
         "paged_over_pages_ms": time_ms(paged),
         "paged_vs_flash_err": float((po - out).abs().max()),
         "paged_bound_ms": bound(w)[0]}
    log(f"whisper-base cross decode: the upcast of one layer's cross K/V {r['upcast_ms']:.4f} ms; the paged "
        f"kernel over the bf16 cache as {n // CROSS_PAGE} pages of {CROSS_PAGE} {r['paged_over_pages_ms']:.4f} ms "
        f"(bound {r['paged_bound_ms']:.4f} ms), vs flash {r['paged_vs_flash_err']:.3e}")
    return r


def check_attention():
    """B5 at every site of ``flash_sites`` and B4 at each served model's
    widths, with the types the model feeds them: bf16 for the dense models,
    f32 queries for zamba2's shared block and whisper's decode.

    The kernels and their plain versions both compute in f32 and differ in
    summation order only, so they agree to one bf16 step in bf16 and to
    2e-5 in f32 (the card tests' tolerance). The model's eager
    attention rounds p to bf16 before PV (the kernels, like the TPU
    kernels, do not), so it is held at the JAX tests' bf16 tolerance, 2e-2.
    ``library_ms`` times ``scaled_dot_product_attention``, which the port
    never calls. Returns {kernel: {model: row}}; a model's B5 row is its
    prompt's, with its other sites under "sites"."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import work
    from repro_torch.models import common

    bf = torch.bfloat16
    dtypes = {"bf16": bf, "f32": torch.float32}
    sites = flash_sites(get_config("whisper-base").n_audio_frames)
    results = {"flash_attention": {}, "paged_attention": {}}
    for arch, (hq, hkv, d) in ATTN_WIDTHS.items():
        g = torch.Generator().manual_seed(3)
        rand = lambda *shape, dtype: torch.randn(*shape, generator=g).to(dtype).cuda()
        # a projection's output (B, L, H * d) viewed as (B, H, L, d)
        proj = lambda b, n, h, dtype: rand(b, n, h * d, dtype=dtype).reshape(b, n, h, d).transpose(1, 2)
        for _, site, b, lq, lk, qname, causal, kv in (s for s in sites if s[0] == arch):
            qdt = dtypes[qname]
            q = rand(b, hq, lq, d, dtype=qdt) if kv == "rope" else proj(b, lq, hq, qdt)
            if kv == "cache":
                ck, cv = rand(b, hkv, lk, d, dtype=bf), rand(b, hkv, lk, d, dtype=bf)
                k, v = ck.to(qdt), cv.to(qdt)
            else:
                k = rand(b, hkv, lk, d, dtype=qdt) if kv == "rope" else proj(b, lk, hkv, qdt)
                v = proj(b, lk, hkv, qdt)
            shapes = (f"q ({b}, {hq}, {lq}, {d}), k/v ({b}, {hkv}, {lk}, {d}) {qname}"
                      + (" (the bf16 cache upcast)" if kv == "cache" else "")
                      + (", causal" if causal else ", non-causal"))
            r = check_flash(q, k, v, causal, shapes)
            log_row("flash_attention", arch if site == "prompt" else f"{arch} {site}", r)
            if kv == "cache":
                r.update(paged_over_pages(q, ck, cv))
            if site == "prompt":
                results["flash_attention"][arch] = r
            else:
                results["flash_attention"][arch].setdefault("sites", {})[site] = r
        qdt = dtypes["f32" if arch in ATTN_F32_Q else "bf16"]
        qname, qsz = ("f32", 4) if qdt == torch.float32 else ("bf16", 2)
        close = (lambda a, b: bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5))) if qdt == torch.float32 \
            else within_one_bf16_step
        # B4: one decode step of 8 slots over the engine's per-slot cache,
        # viewed as pages without a copy
        kc, vc = rand(8, hkv, DECODE_S, d, dtype=bf), rand(8, hkv, DECODE_S, d, dtype=bf)
        qd = rand(8, hq, d, dtype=qdt)
        lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
        kp, vp, table = pa.cache_as_pages(kc, vc, DECODE_PAGE)
        call = lambda: pa.paged_attention(qd, kp, vp, table, lengths)
        out = call()
        plain = pa.paged_attention_ref(qd, kp, vp, table, lengths)
        eager = common.attention_decode(qd[:, :, None], kc, vc, lengths)[:, :, 0]
        torch.cuda.synchronize()
        assert close(out, plain), f"paged_attention differs from plain ({arch})"
        torch.testing.assert_close(out.float(), eager.float(), rtol=2e-2, atol=2e-2)
        w = work.paged_attention(8, hq, hkv, d, qsz, 2, DECODE_S // DECODE_PAGE, DECODE_PAGE, DECODE_LENGTHS)
        nbytes = w[0]
        b_ms, b_by = bound(w)
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
    for arch, r in results["paged_attention"].items():
        log_row("paged_attention", arch, r)
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


# the training phase: train_4k's sequence length at full width, each model
# from random weights on one fixed batch in 2 micro-batches (its rows cut
# from train_4k's 256 so that a step fits the smoke): smollm-360m 8 rows,
# 5 steps; zamba2-1.2b and rwkv6-7b 4 rows, whisper-base 8 (over as many
# clips of 1,500 frames), 3 steps; rwkv6-7b cut to 4 of its 32 layers (its
# 7.6 B params with AdamW's state need ~122 GB, the card has 80)
TRAIN_SEQ, TRAIN_ACCUM = 4096, 2
TRAIN_RUNS = {  # arch -> (rows, steps, layers kept or None)
    "smollm-360m": (8, 5, None),
    "zamba2-1.2b": (4, 3, None),
    "whisper-base": (8, 3, None),
    "rwkv6-7b": (4, 3, 4),
}
# the full widths each run asserts: (layers, d_model, heads, kv heads, d_ff, vocab)
TRAIN_WIDTHS = {"smollm-360m": (32, 960, 15, 5, 2560, 49152), "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
                "whisper-base": (6, 512, 8, 8, 2048, 51865), "rwkv6-7b": (32, 4096, 64, 64, 14336, 65536)}
TRAIN_LR = 1e-3
# B5's lse against its plain version: both are m + log(l) over the same
# f32 scores (exact bf16 products, summed in other orders), the kernel's
# exponentials on the special-function unit (2^-22 relative each); over
# 4,096 keys that moves log(l) by some 1e-6, and lse is O(10)
LSE_TOL = 1e-4
# B5 with its stats at the training forward's sites, bf16, a micro-batch
# each: (model, site, rows, query heads, kv heads, Lq, Lk, causal)
TRAIN_ATTN_SITES = [
    ("smollm-360m", "self", 4, 15, 5, TRAIN_SEQ, TRAIN_SEQ, True),
    ("whisper-base", "encoder", 4, 8, 8, 1500, 1500, False),
    ("whisper-base", "self", 4, 8, 8, TRAIN_SEQ, TRAIN_SEQ, True),
    ("whisper-base", "cross", 4, 8, 8, TRAIN_SEQ, 1500, False),
    ("zamba2-1.2b", "shared", 2, 32, 32, TRAIN_SEQ, TRAIN_SEQ, True),
]


def _train_attention_row(label: str, b: int, hq: int, hkv: int, lq: int, lk: int, causal: bool, seed: int,
                         d: int = 64, q_offset: int = 0) -> dict:
    """One row of ``check_train_attention``/``check_sp_attention``: B5 with
    its stats on random bf16 inputs against its plain version and timed.
    The library call is ``aten._scaled_dot_product_flash_attention`` (K/V
    repeated to the query heads) where the rows start at 0, and
    ``aten._scaled_dot_product_efficient_attention`` under the same mask as
    an additive bias where they start at ``q_offset`` (both return a
    logsumexp)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import work

    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16).cuda()
    q, k = rand(b, hq, lq, d), rand(b, hkv, lk, d)
    v = rand(b, lk, hkv * d).reshape(b, lk, hkv, d).transpose(1, 2)  # the projection's view, as the model's
    kw = dict(causal=causal, lk_valid=lk, q_offset=q_offset)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    bare = fa.flash_attention(q, k, v, **kw)
    plain, plain_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    krep, vrep = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    if q_offset == 0:
        library = lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, krep, vrep, 0.0, causal)
    else:
        rows = torch.arange(lq, device="cuda")[:, None] + q_offset
        bias = torch.where(torch.arange(lk, device="cuda")[None, :] <= rows, 0.0, float("-inf"))
        bias = bias.to(torch.bfloat16).expand(b, hq, lq, lk)
        library = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q, krep, vrep, bias, True)
    lib_lse = library()[1]
    torch.cuda.synchronize()
    lse_err = float((lse - plain_lse).abs().max())
    assert torch.equal(out, bare), f"B5's output changed when asked for its stats ({label})"
    assert within_one_bf16_step(out, plain), f"flash_attention with lse differs from plain ({label})"
    assert lse.shape == (b, hq, lq) and lse.dtype == torch.float32 and lse_err <= LSE_TOL, (label, lse_err)
    w = work.flash_attention(b, hq, hkv, lq, lk, d, 2, causal, q_offset=q_offset, return_lse=True)
    nbytes, nops = w[0], w[1]
    b_ms, b_by = bound(w)
    r = {"shapes": f"q ({b}, {hq}, {lq}, {d}), k/v ({b}, {hkv}, {lk}, {d}) bf16, "
                   f"{'causal' if causal else 'non-causal'}, q_offset {q_offset}, lse f32 ({b}, {hq}, {lq})",
         "max_abs_err": float((out.float() - plain.float()).abs().max()), "lse_max_abs_err": lse_err,
         "lse_vs_library": float((lse - lib_lse.float()[..., :lq]).abs().max()),
         "ms": time_ms(lambda: fa.flash_attention(q, k, v, **kw, return_lse=True)),
         "ms_without_lse": time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
         "plain_ms": time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw, return_lse=True), reps=10),
         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
         "library_ms": time_ms(library)}
    log(f"flash_attention [training forward, {label}, with lse] {r['shapes']}: max_abs_err vs plain "
        f"{r['max_abs_err']:.3e} (one bf16 step), lse {lse_err:.3e} (tolerance {LSE_TOL}), lse vs the "
        f"library's {r['lse_vs_library']:.3e}; kernel {r['ms']:.4f} ms, without lse "
        f"{r['ms_without_lse']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.1f} GFLOP), library {r['library_ms']:.4f} ms; at "
        f"{b_ms / r['ms']:.4f} of its bound, {r['ms'] / r['library_ms']:.3f}x the library's time")
    return r


def check_train_attention():
    """B5 asked for its softmax stats at each training site
    (``TRAIN_ATTN_SITES``): smollm-360m's causal layers, whisper-base's
    non-causal encoder over 1,500 frames (23 key tiles of 64 and one of 28)
    and cross-attention (4,096 queries over them) and its causal decoder,
    zamba2-1.2b's cast shared block (32/32 heads). Each output within one
    bf16 step of the plain version and equal to the launch without stats
    bit for bit; the lse within ``LSE_TOL``. Timed with and without the
    stats, beside the plain version and one PyTorch call that also returns
    a logsumexp (``aten._scaled_dot_product_flash_attention``, K/V
    repeated to the query heads), with the bound. Returns the rows by
    "model site"."""
    return {f"{arch} {site}": _train_attention_row(f"{arch} {site}", b, hq, hkv, lq, lk, causal, 6 + i)
            for i, (arch, site, b, hq, hkv, lq, lk, causal) in enumerate(TRAIN_ATTN_SITES)}


# B5 with its stats at sequence-parallel training rows (``sp_activations``,
# ``train_mesh_phase``): qwen1.5-110b's 64/8 heads of 128 over a causal
# 2,048, the query rows of rank 1 of 2 and of rank 3 of 4 (their q_offset
# the rank's first row), a rank's rows of train_mesh_phase's 4-row batch:
# (site, rows, query heads, kv heads, Lq, Lk, q_offset)
SP_ATTN_SITES = [
    ("rank 1 of 2", 2, 64, 8, 1024, 2048, 1024),
    ("rank 3 of 4", 4, 64, 8, 512, 2048, 1536),
]


def check_sp_attention():
    """B5 with its stats at ``SP_ATTN_SITES`` (a non-zero ``q_offset``: the
    causal mask and the lse at the rows' global positions), held to the
    plain version as ``check_train_attention`` holds its sites, and timed
    beside the efficient-attention call under the same mask."""
    return {f"qwen1.5-110b sp {site}": _train_attention_row(f"qwen1.5-110b sp {site}", b, hq, hkv, lq, lk, True,
                                                            20 + i, d=128, q_offset=off)
            for i, (site, b, hq, hkv, lq, lk, off) in enumerate(SP_ATTN_SITES)}


SCAN_RTOL = 1e-4  # see check_scans


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

    from repro_torch.kernels import mamba2_scan, rwkv6_scan, work

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
                 lambda b, t, st: work.wkv6(b, t, h, hd, st), "r, k, v, lw"),
        "ssd": (mamba2_scan.ssd_chunked, mamba2_scan.ssd_ref, ssd_case,
                lambda b, t, st: work.ssd(b, t, h, hd, hd, st), "x"),
    }
    shapes = {"prefill": (1, PREFILL_LEN, False), "prefill_state": (1, PREFILL_LEN, True),
              "decode": (8, 1, True)}
    results = {}
    for name, (op, plain, make, count, inputs) in specs.items():
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
            w = count(b, t, given)
            nbytes, nops = w[0], w[1]
            b_ms, b_by = bound(w)
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


TRAIN_SCAN_ROWS = 2  # a training micro-batch of the recurrent runs (4 rows in 2 micro-batches)


def check_train_scans():
    """B6 and B7 asked for their chunk-entry states at the training forward's
    shape: a micro-batch of ``TRAIN_SCAN_ROWS`` x ``TRAIN_SEQ`` tokens,
    rwkv6-7b's 64 heads of 64 and zamba2-1.2b's 64 heads of P = N = 64,
    from a zero state as the models' layers start, the decays as
    ``check_scans`` draws them. y and the final state equal the launch
    without the states bit for bit; the states (B, H, 128, 64, 64) within
    ``SCAN_RTOL`` of the plain version's (the sequential recurrence
    sampled at every 32nd step), as y and the final state are. Timed with
    the states at the wrapper's split (``split_count``: 2 at 2 x 64
    sequences) and at a split of 1, without them, beside the plain version
    and the bound (the states' bytes added); and the chunked VJP in plain
    PyTorch that reads them (``ref.wkv6_vjp``, ``ref.ssd_vjp``), from
    random cotangents. ``library_ms`` is null: no one PyTorch call
    computes either scan."""
    import torch

    from repro_torch.kernels import mamba2_scan, rwkv6_scan, work
    from repro_torch.kernels.mamba2_scan import ops as ssd_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

    rng = np.random.default_rng(9)
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    normal = lambda *shape: t_(rng.standard_normal(shape))
    b, t, h, hd = TRAIN_SCAN_ROWS, TRAIN_SEQ, 64, 64
    c = -(-t // work.CHUNK)
    lw = t_(-np.minimum(np.exp(rng.normal(-1.0, 1.5, (b, t, h, hd))), 10.0))
    dt = t_(np.log1p(np.exp(rng.normal(0.0, 1.5, (b, t, h)))))
    specs = {
        "wkv6": (wkv_ops, rwkv6_scan.wkv6_ref, rwkv6_scan.wkv6_vjp,
                 [normal(b, t, h, hd), normal(b, t, h, hd), normal(b, t, h, hd), lw, normal(h, hd), None],
                 work.wkv6(b, t, h, hd, False, return_states=True), "r, k, v, lw"),
        "ssd": (ssd_ops, mamba2_scan.ssd_ref, mamba2_scan.ssd_vjp,
                [normal(b, t, h, hd), dt, t_(-np.exp(rng.uniform(-2.0, 1.0, h))), normal(b, t, hd),
                 normal(b, t, hd), normal(h), None],
                work.ssd(b, t, h, hd, hd, False, return_states=True), "x"),
    }
    results = {}
    for name, (ops, plain, vjp, args, w, inputs) in specs.items():
        split = ops.ref.split_count(t, b, h)
        y, s, states = ops._launch(*args, None, split, return_states=True)
        bare = ops._launch(*args, None, split)
        y1, s1, states1 = ops._launch(*args, None, 1, return_states=True)
        want = plain(*args, return_states=True)
        torch.cuda.synchronize()
        assert torch.equal(y, bare[0]) and torch.equal(s, bare[1]), f"{name}: y or the state moved with states"
        assert states.shape == (b, h, c, hd, hd), states.shape
        errs = {}
        for label, got in (("split", (y, s, states)), ("split 1", (y1, s1, states1))):
            for what, a, b_ in zip(("y", "final state", "chunk states"), got, want):
                torch.testing.assert_close(a, b_, rtol=SCAN_RTOL, atol=SCAN_RTOL * float(b_.abs().max()),
                                           msg=f"{name} {label} {what}")
                errs[f"{label} {what}"] = float((a - b_).abs().max())
        dy, ds = normal(*y.shape), normal(*s.shape)
        b_ms, b_by = bound(w)  # the chunk states' bytes included
        nops = w[1]
        r = {"shapes": f"{inputs} ({b}, {t}, {h}, {hd}) f32, state zero, chunk states ({b}, {h}, {c}, {hd}, {hd})",
             "max_abs_err": max(errs.values()), "errs": errs, "split": split,
             "ms": time_ms(lambda: ops._launch(*args, None, split, return_states=True), reps=20),
             "ms_without_states": time_ms(lambda: ops._launch(*args, None, split), reps=20),
             "ms_split_1": time_ms(lambda: ops._launch(*args, None, 1, return_states=True), reps=20),
             "plain_ms": time_ms(lambda: plain(*args, return_states=True), reps=3),
             "vjp_ms": time_ms(lambda: vjp(*args, states, dy, ds), reps=5),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bytes": w[0], "ops": nops}
        log(f"{name} [training forward, with chunk states] {r['shapes']}: max_abs_err vs plain {errs} (rtol "
            f"{SCAN_RTOL}, atol {SCAN_RTOL} x max|plain|), y and final state bit-equal without states; kernel "
            f"{r['ms']:.4f} ms at split {split}, without states {r['ms_without_states']:.4f} ms, with states at "
            f"split 1 {r['ms_split_1']:.4f} ms, plain {r['plain_ms']:.1f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{r['bytes'] / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP; at {b_ms / r['ms']:.4f} of it), library none; "
            f"its chunked VJP (plain PyTorch) {r['vjp_ms']:.3f} ms")
        results[name] = r
        del y, s, states, bare, y1, s1, states1, want
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


@contextlib.contextmanager
def flash_site_counts(sites: dict):
    """Count flash launches by call site while the block runs: each site's
    function (``sites``: name -> (module, attribute)) is wrapped so that the
    rise of the flash wrapper's count over its calls adds to that site's
    count. Yields the counts; the functions are restored on exit."""
    import importlib

    from repro_torch.kernels import flash_attention as fa

    counts, saved = dict.fromkeys(sites, 0), []
    for site, (mod_name, attr) in sites.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def counted(*a, _site=site, _orig=orig, **k):
            n0 = fa.LAUNCHES["flash_attention"]
            try:
                return _orig(*a, **k)
            finally:  # a remat recompute that stops early leaves by an exception
                counts[_site] += fa.LAUNCHES["flash_attention"] - n0

        saved.append((mod, attr, orig))
        setattr(mod, attr, counted)
    try:
        yield counts
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def draw_on_card(api, seed: int = 0):
    """``api``'s random parameters drawn on the card: ``ModelAPI.init``'s
    initializers and distributions from a generator of the card (its
    Philox stream, the same on every card of one kind) instead of the
    host's, whose serial stream draws ~70 M parameters a second (~100 s
    for a 7 B model on an H100 machine's host). Other values than
    ``api.init(seed)``'s: the card-vs-CPU checks draw theirs with it."""
    import torch

    from repro_torch.models.api import _PORTED

    with torch.device("cuda"):
        return _PORTED[api.family].init(api.cfg, torch.Generator("cuda").manual_seed(seed),
                                        device=torch.device("cuda"))


def serve(card: str, arch: str, n_requests: int, widths: tuple, ssm=None, sites=None):
    """The main path on one model at full width: an engine answering
    ``n_requests`` Web1 requests, every kernel launch counted. ``widths``:
    (layers, d_model, heads, KV heads, d_ff, vocab), the published config's;
    ``ssm``: (ssm_head_dim, ssm_state,
    shared_attn_every) of a recurrent family; ``sites``: the functions
    holding the model's flash sites (``flash_site_counts``), whose launches
    are then counted site by site."""
    import torch

    import repro_torch.runtime.tiered_kv as tiered_kv_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model, kernel_launches

    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == widths, cfg
    assert ssm is None or (cfg.ssm_head_dim, cfg.ssm_state, cfg.shared_attn_every) == ssm, cfg
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = draw_on_card(api)
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

    with flash_site_counts(sites or {}) as per_site:
        flash0 = fa.LAUNCHES["flash_attention"]
        eng = make_engine(api, params, **ECFG)
        at_capture, captured = dict(per_site), fa.LAUNCHES["flash_attention"] - flash0
        tiered_kv_mod.tiered_lookup_segments = timed
        zero_launch_counts()
        try:
            run = drive(eng, reqs, step_events=True)
        finally:
            tiered_kv_mod.tiered_lookup_segments = orig
        eager_sites = {site: n - at_capture[site] for site, n in per_site.items()}
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
    assert {k: graph.launches.get(k, 0) for k in want} == kernel_launches(cfg, 0, 1), graph.launches
    assert dev["near_hits"] > 0 and dev["far_hits"] > 0, dev
    flash_sites = None
    if sites:
        # the eager sites hold every eager flash launch; and every flash
        # launch made while the engine warmed up and captured its decode came
        # from one site's function, so the decode graph's are that site's
        owner = [site for site, n in at_capture.items() if n]
        assert sum(at_capture.values()) == captured and len(owner) <= 1, (at_capture, captured)
        assert sum(eager_sites.values()) == eager["flash_attention"], (eager_sites, eager)
        flash_sites = {"prefill": eager_sites, "decode_graph": {
            site: graph.launches["flash_attention"] * graph.replays for site in owner}}
        log(f"{arch} flash launches by site: {flash_sites} (of {launches['flash_attention']})")
    # the logits of one more decode of the final batch, and of one prefill
    cache = {k: v.clone() for k, v in eng.cache.items()}
    logits, _ = api.decode(params, cache, eng.next_tokens[:, None], page_size=ECFG["page_size"])
    pre, _ = api.prefill(params, eng._prefill_batch(reqs[0].tokens[:64]), max_len=64)
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
            "streams": run["streams"], "tokens_per_s": toks_per_s, "profile": budget,
            "flash_sites": flash_sites}


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


def path_summary(eng, run: dict, same: list, launches: dict) -> dict:
    """A second pass over a main path's requests (``drive`` with step
    events): TTFT on the device timeline (every request is submitted before
    the first step, whose start is events[0]) and in steps, tokens/s, step
    p50/p99, and the share of requests whose tokens equal the whole-slot
    engine's (``same``)."""
    st = eng.stats()
    sv, ev = st["serving"], run["events"]
    ttft_ms = [ev[0].elapsed_time(ev[j + 1]) for j in run["first"].values()]
    return {
        "ttft_p50_ms": pct(ttft_ms, 50), "ttft_p99_ms": pct(ttft_ms, 99),
        "ttft_p50_steps": sv["ttft_p50"], "ttft_p99_steps": sv["ttft_p99"],
        "tokens_per_s": st["tokens_decoded"] / run["wall"],
        "step_p50_ms": pct(run["step_ms"], 50), "step_p99_ms": pct(run["step_ms"], 99),
        "steps": eng.engine_steps, "columns": eng.chunk_columns, "wall_s": run["wall"],
        "same_tokens_share": sum(same) / len(same), "launches": launches,
    }


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
    ws = mp["streams"]
    same = [run["streams"][rid][1:] == ws[rid] for rid in ws]
    res = path_summary(eng, run, same, launches)
    log(f"{arch} chunked [{card}]: {len(reqs)} requests, {st['tokens_decoded']} tokens decoded, "
        f"{st['prefill_tokens']} prompt tokens in chunks of {CHUNK}, {run['wall']:.3f} s wall; "
        f"TTFT p50 {res['ttft_p50_ms']:.1f} ms, p99 {res['ttft_p99_ms']:.1f} ms (device timeline; "
        f"{res['ttft_p50_steps']:.1f} / {res['ttft_p99_steps']:.1f} steps); {res['tokens_per_s']:.1f} "
        f"tokens/s; step p50 {res['step_p50_ms']:.3f} ms, p99 {res['step_p99_ms']:.3f} ms; "
        f"requests with the whole-slot engine's tokens {sum(same)} of {len(same)}")
    return res


def serve_unchunkable(card: str, arch: str, mp: dict) -> dict:
    """A family the reference never chunks (vlm, audio) given the chunked
    phase's budget (``prefill_chunk=CHUNK``): the engine prefills whole at
    admission as on the main path and captures no column graph, and each
    request's tokens equal the whole-slot engine's (the same kernels on the
    same inputs); launches as ``kernel_launches`` counts them; no host
    read in a step that neither drains nor admits."""
    from repro_torch.models.api import kernel_launches

    api, params, cfg, reqs = mp["api"], mp["params"], mp["cfg"], mp["reqs"]
    eng = make_engine(api, params, **ECFG, prefill_chunk=CHUNK)
    assert not eng.chunking and sorted(eng._graphs) == ["decode"], (eng.chunking, sorted(eng._graphs))
    zero_launch_counts()
    run = drive(eng, [dataclasses.replace(r) for r in reqs], step_events=True, quiet_check=True)
    launches = path_launches(eng, launch_counts())
    st = eng.stats()
    sv, q = st["serving"], run["quiet"]
    decodes = eng.model_dispatches - eng.prefill_dispatches
    want = kernel_launches(cfg, eng.prefill_dispatches, decodes)
    assert st["requests_finished"] == len(reqs), st["requests_finished"]
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert eng.prefill_dispatches == len(reqs) and eng.chunk_columns == 0, sv
    assert q["steps"] > 0 and q["reads"] == 0 and not q["syncs"], q
    ws = mp["streams"]
    same = [run["streams"][rid] == ws[rid] for rid in ws]
    assert all(same), [rid for rid, ok in zip(ws, same) if not ok]
    res = path_summary(eng, run, same, launches)
    log(f"{arch} with prefill_chunk {CHUNK} [{card}]: not chunkable, {eng.prefill_dispatches} whole prefills "
        f"at admission, no column graph; launches {launches}; {q['steps']} quiet steps, {q['reads']} host "
        f"reads; every request's tokens equal the whole-slot engine's ({len(same)} of {len(same)}); "
        f"{res['tokens_per_s']:.1f} tokens/s, TTFT p50 {res['ttft_p50_ms']:.1f} ms")
    return res


def vlm_checks(card: str, mp: dict) -> dict:
    """Phase 3f's checks of M-RoPE at qwen2-vl-7b's full width: a prefill of
    an image's embeddings at 3-D positions (16 text tokens, a 16 x 16 grid
    of patches at one t, 32 text tokens, the channels resuming past the
    grid) gives finite logits that differ from the same embeddings at 1-D
    positions; and the engine's input (the embedding rows, three equal
    channels at the text positions) gives the token path's logits and cache
    bit for bit."""
    import torch

    from repro_torch.models import transformer

    api, params, cfg = mp["api"], mp["params"], mp["cfg"]
    g = torch.Generator().manual_seed(9)
    before, grid, after = 16, 16, 32
    toks = torch.as_tensor(mp["reqs"][1].tokens[: before + after]).long().cuda()
    patches = (torch.randn(1, grid * grid, cfg.d_model, generator=g) * 0.02).cuda()
    emb = torch.cat([params.embed[toks[:before]][None], patches, params.embed[toks[before:]][None]], dim=1)
    ii, jj = torch.meshgrid(torch.arange(grid), torch.arange(grid), indexing="ij")
    text0, text1 = torch.arange(before), before + grid + torch.arange(after)
    pos = torch.stack([torch.cat([text0, torch.full((grid * grid,), before), text1]),
                       torch.cat([text0, before + ii.reshape(-1), text1]),
                       torch.cat([text0, before + jj.reshape(-1), text1])]).to(torch.int32)[:, None].cuda()
    n = emb.shape[1]
    logits, cache = api.prefill(params, {"embeds": emb, "mrope_positions": pos}, max_len=ECFG["max_len"])
    flat = torch.arange(n, dtype=torch.int32, device="cuda").expand(3, 1, n)
    logits_1d, _ = api.prefill(params, {"embeds": emb, "mrope_positions": flat}, max_len=ECFG["max_len"])
    assert logits.shape == (1, n, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    moved = float((logits - logits_1d).abs().max())
    assert moved > 0, moved
    t = toks[None].to(torch.int32)
    le, ce = api.prefill(params, {"embeds": params.embed[t.long()],
                                  "mrope_positions": torch.arange(t.shape[1], dtype=torch.int32,
                                                                  device="cuda").expand(3, 1, t.shape[1])},
                         max_len=ECFG["max_len"])
    lt, ct = transformer.prefill(params, cfg, t, max_len=ECFG["max_len"])
    equal = bool(torch.equal(le, lt)) and all(torch.equal(ce[k], ct[k]) for k in ce)
    log(f"{cfg.name} M-RoPE [{card}]: a prefill of {before} + {grid}x{grid} image patches + {after} tokens "
        f"at 3-D positions: logits finite, max |diff| from 1-D positions {moved:.4f}; embeds with three equal "
        f"channels vs the token path over {t.shape[1]} tokens: logits and cache bit-equal {equal}")
    assert equal
    return {"grid_vs_1d_max_diff": moved, "equal_channels_bit_equal": equal}


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
        # qwen2-vl's GQA group of 7 at head_dim 64: 7 query heads over 1 KV
        # head, the M-RoPE sections summing to 64 / 2
        (dataclasses.replace(get_config("qwen2-vl-7b").reduced(), d_model=448, n_heads=7, n_kv_heads=1,
                             mrope_sections=(8, 12, 12)),
         "qwen2-vl (head_dim 64, 7/1 heads, M-RoPE (8, 12, 12); flash + paged)"),
        # whisper at head_dim 64: 2/2 heads over d 128, 16 audio frames
        (dataclasses.replace(get_config("whisper-base").reduced(), d_model=128, n_heads=2, n_kv_heads=2),
         "whisper (2 + 2 layers, head_dim 64, 2/2 heads, 16 frames; flash non-causal + causal + paged)"),
    ]


def reduced_on_card_vs_cpu(small, label: str):
    """A reduced model on the card (kernels, under graphs) against the same
    engine on the CPU (plain versions), on the whole-slot path and on the
    chunked path (prefill_chunk 8): prefill logits, books and tokens."""
    import torch

    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.models.api import get_model, kernel_launches
    from repro_torch.runtime.serving import CHUNKABLE_FAMILIES, EngineConfig, ServingEngine

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
            assert (e.prefill_dispatches == 0) == e.chunking and e.batch_decodes > 0, (label, chunk)
            assert e.chunking == (chunk > 0 and small.family in CHUNKABLE_FAMILIES), (label, chunk)
            logits, _ = sapi.prefill(sp, e._prefill_batch(np.arange(24)), max_len=32)
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
        if chunk and small.family not in CHUNKABLE_FAMILIES:
            path = f"whole-slot (prefill_chunk {chunk}, not chunkable)"
        log(f"reduced {label}, {path}, on the card vs the CPU (plain versions): prefill logits max "
            f"|diff| {err:.3e}, per-step tokens equal {match:.4f}, live counters and books equal")


# ---------------------------------------------------------------------------
# phase 8: training (loss, gradients, AdamW) on the card


def train_batch(cfg, rows: int, seq: int, seed: int, device: str) -> dict:
    """``rows`` sequences of ``seq`` tokens drawn with numpy from ``seed``,
    Zipf-like over the vocabulary (p ~ 1 / (rank + 10)), the labels the
    next token (the last position ignored): a fixed batch a model can
    learn from in a few steps. An audio model's batch also holds ``rows``
    clips of its ``n_audio_frames`` frames (the front end's stub), normal
    draws from the same generator. A vlm's holds, in place of the tokens,
    embeddings (the vision tower's stub: normal draws at 0.02, the labels
    still Zipf-like, so the loss can fall) and (3, rows, seq) M-RoPE
    positions: the three channels the same positions, each row's offset
    apart."""
    import torch

    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(cfg.vocab_size) + 10.0)
    tokens = rng.choice(cfg.vocab_size, size=(rows, seq + 1), p=p / p.sum()).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[:, -1] = -1
    batch = {"tokens": torch.from_numpy(tokens[:, :-1].copy()).to(device),
             "labels": torch.from_numpy(labels).to(device)}
    if cfg.family == "audio":
        frames = rng.standard_normal((rows, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames).to(device)
    if cfg.family == "vlm":
        del batch["tokens"]
        embeds = (rng.standard_normal((rows, seq, cfg.d_model)) * 0.02).astype(np.float32)
        batch["embeds"] = torch.from_numpy(embeds).to(device)
        pos = np.arange(seq)[None, None, :] + rng.integers(0, 8, (1, rows, 1))
        batch["mrope_positions"] = torch.from_numpy(np.repeat(pos, 3, 0).astype(np.int32)).to(device)
    return batch


def train_models():
    """Reduced configs the training path takes on the card: attention
    head_dim 64 (the kernel's), the scans' reduced 16, f32 compute as
    ``.reduced()`` sets it (B5 on TF32 tensor cores, three products a
    product; B6 and B7 f32); zamba2 with 5 layers (two groups of 2 and a
    tail layer, so both nestings of its remat run), whisper over 100 frames
    (a ragged key tile of 36)."""
    from repro_torch.configs import get_config

    def reduced(arch, **kw):
        return dataclasses.replace(get_config(arch).reduced(), **kw)

    return [
        (reduced("smollm-360m", d_model=192, n_heads=3, n_kv_heads=1), "smollm (head_dim 64, 3/1 heads)"),
        (reduced("granite-moe-3b-a800m", d_model=192, n_heads=3, n_kv_heads=1),
         "granite-moe (head_dim 64, 3/1 heads, 8 experts top-2)"),
        (reduced("rwkv6-7b"), "rwkv6 (4 wkv heads of 16)"),
        (reduced("zamba2-1.2b", d_model=128, n_heads=2, n_kv_heads=2, n_layers=5),
         "zamba2 (5 layers, 16 SSD heads of 16, N 16; shared block 2/2 of 64)"),
        (reduced("whisper-base", d_model=128, n_heads=2, n_kv_heads=2, n_audio_frames=100),
         "whisper (2/2 heads of 64, 100 frames)"),
    ]


# the reduced loss and gradients on the card against the CPU: both f32,
# B5's products on the card are three TF32 products (21-22 bits, 2e-5 on
# its outputs against plain) and every sum runs in another order, which
# two layers carry into each gradient leaf at some 1e-5 of its scale; the
# scans' closed forms on the card against their sequential plain versions
# within 1e-4 of each value, the VJP the same code on both
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4


def train_reduced_card_vs_cpu():
    """One loss and gradient of each reduced training model on the card
    (B5, B6, B7 in the Functions' forwards) and on the CPU (the plain
    versions), from the same seed-0 weights and batch: the loss and its
    metrics within ``TRAIN_LOSS_RTOL``, each gradient leaf within
    ``TRAIN_GRAD_TOL`` of its largest magnitude; the kernels launched on
    the card as ``train_kernel_launches`` gives (with remat: B5 twice a
    layer, B6 twice a layer, B7 three times a grouped zamba2 layer), none
    on the CPU."""
    import torch

    from repro_torch.models.api import get_model, train_kernel_launches, trainable

    out = {}
    for small, label in train_models():
        api = get_model(small)
        want = {k: v for k, v in train_kernel_launches(small, 1).items() if k != "paged_attention"}
        res = {}
        for where in ("cuda", "cpu"):
            model = api.init(seed=0, device=where)
            named = trainable(model)
            for prm in named.values():
                prm.requires_grad_(True)
            zero_launch_counts()
            loss, metrics = api.loss(model, train_batch(small, 4, 64, seed=1, device=where))
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
            launched = {k: launch_counts()[k] for k in want}
            assert launched == (want if where == "cuda" else dict.fromkeys(want, 0)), (label, where, launched)
            res[where] = (loss.detach().cpu(), {k: v.detach().cpu() for k, v in metrics.items()},
                          {n: g.cpu() for n, g in zip(named, grads)})
        (lg, mg, gg), (lc, mc, gc) = res["cuda"], res["cpu"]
        assert abs(float(lg - lc)) <= TRAIN_LOSS_RTOL * abs(float(lc)), (label, float(lg), float(lc))
        for k in mc:
            assert abs(float(mg[k] - mc[k])) <= TRAIN_LOSS_RTOL * max(abs(float(mc[k])), 1.0), (label, k)
        worst = max(float((gg[n] - gc[n]).abs().max()) / max(float(gc[n].abs().max()), 1e-30) for n in gc)
        assert worst <= TRAIN_GRAD_TOL and all(bool(torch.isfinite(g).all()) for g in gg.values()), (label, worst)
        log(f"training [{label}] on the card vs the CPU: loss {float(lg):.6f} vs {float(lc):.6f}, worst gradient "
            f"leaf {worst:.3e} of its scale (tolerance {TRAIN_GRAD_TOL}), {len(gc)} leaves, launches {want}")
        out[label] = {"loss_card": float(lg), "loss_cpu": float(lc), "worst_grad_rel": worst, "launches": want}
    return out


# profiler ranges a profiled step wraps around the functions that make up
# its device time: (module, function) -> label. ``matmul_f32``'s range
# covers only its operands' upcast, in every model module that calls it.
TRAIN_RANGES = {("repro_torch.models.common", "matmul_f32"): "train.upcast",
                ("repro_torch.models.common", "_attention_bwd"): "train.attention_bwd",
                ("repro_torch.models.common", "_ce_chunk"): "train.fused_ce",
                ("repro_torch.kernels.rwkv6_scan.ref", "wkv6_vjp"): "train.scan_vjp",
                ("repro_torch.kernels.mamba2_scan.ref", "ssd_vjp"): "train.scan_vjp"}


@contextlib.contextmanager
def annotated(ranges: dict):
    """Profiler ranges around functions of the port for one profiled step,
    the functions themselves unchanged: ``ranges`` (module, name) -> the
    range's label. ``matmul_f32``'s range covers only its operands' upcast,
    and it is wrapped in every loaded module that holds it by name."""
    import importlib

    import torch
    from torch.profiler import record_function

    def upcast_matmul(a, b):
        with record_function(ranges[("repro_torch.models.common", "matmul_f32")]):
            a, b = a.float(), b.float()
        return torch.matmul(a, b)

    def ranged(fn, label):
        def inner(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return inner

    saved = []
    for (mod_name, attr), label in ranges.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        holders = [mod]
        if attr == "matmul_f32":
            holders += [m for n, m in list(sys.modules.items())
                        if n.startswith("repro_torch.") and m is not mod and getattr(m, attr, None) is orig]
        for m in holders:
            saved.append((m, attr, orig))
            setattr(m, attr, upcast_matmul if attr == "matmul_f32" else ranged(orig, label))
    try:
        yield
    finally:
        for m, attr, orig in saved:
            setattr(m, attr, orig)


def range_device_ms(prof, label: str, ops=None, backward: bool = False) -> float:
    """Device time of the kernels launched inside every ``label`` range of
    a profile (through the ops under it, or only those named in ``ops``);
    with ``backward``, also those of the backward nodes of the ops run
    inside the ranges (an autograd node carries its forward op's thread and
    sequence number)."""
    events = prof.events()
    roots = [ev for ev in events if ev.name == label and ev.device_type.name == "CPU"]
    if backward:
        seqs = set()

        def mark(ev):
            if ev.sequence_nr >= 0:
                seqs.add((ev.thread, ev.sequence_nr))
            for child in ev.cpu_children:
                mark(child)

        for ev in roots:
            mark(ev)
        roots += [ev for ev in events if ev.name.startswith("autograd::engine::evaluate_function")
                  and (ev.fwd_thread, ev.sequence_nr) in seqs]
    total = 0.0

    def walk(ev, inside_op):
        nonlocal total
        inside_op = inside_op or ops is None or ev.name in ops
        if inside_op:
            total += sum(k.duration for k in ev.kernels)
        for child in ev.cpu_children:
            walk(child, inside_op)

    for ev in roots:
        walk(ev, False)
    return total / 1e3


# the scan kernels' and B5's kernels by name in a profile
KERNEL_KEYS = {"flash_attention": "fa_tc_kernel", "wkv6": "wkv6_", "ssd": "ssd_"}


def train_full_width(card: str, arch: str):
    """One model of ``TRAIN_RUNS`` at full width (depth cut where the run
    says), random seed-0 weights, taking its steps of AdamW (clip_norm 1.0)
    through ``make_train_step`` on one fixed batch of rows x ``TRAIN_SEQ``
    tokens in ``TRAIN_ACCUM`` micro-batches, remat on. Every step launches
    the model kernels exactly as ``train_kernel_launches`` gives (B5 with
    its stats, B6 and B7 with their chunk-entry states) and no other
    kernel of the port; no host read inside it (CUDA sync checking on); the
    metrics read at its end. The loss must fall from step 1 to the last,
    the gradient norm stay finite. Then one more step under the profiler
    for where its device time goes: the kernels' forwards, the scans'
    chunked VJP, the attention backward, the ``matmul_f32`` upcasts and the
    fused CE, by the ranges of ``TRAIN_RANGES``. whisper-base's B5
    launches are also counted by site (encoder, decoder self-attention,
    cross-attention)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model, make_train_step, train_kernel_launches, trainable
    from repro_torch.optim import AdamWConfig, adamw_init

    rows, steps, layers = TRAIN_RUNS[arch]
    full = get_config(arch)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.d_ff, full.vocab_size) == \
        TRAIN_WIDTHS[arch], full
    cfg = dataclasses.replace(full, grad_accum=TRAIN_ACCUM, n_layers=layers or full.n_layers)
    assert cfg.remat and cfg.remat_policy == "nothing", cfg
    cuts = [f"{rows} sequences a step (train_4k's 256)"] + (
        [f"{layers} of {full.n_layers} layers (the 7.6 B params and AdamW state need ~122 GB)"] if layers else [])
    api = get_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold on the card
    model = api.init(seed=0, device="cuda")
    batch = train_batch(cfg, rows, TRAIN_SEQ, seed=0, device="cuda")
    named = trainable(model)
    n_params = sum(p.numel() for p in named.values())
    state = adamw_init({n: p.detach() for n, p in named.items()})
    step = make_train_step(api, AdamWConfig(lr=TRAIN_LR, clip_norm=1.0))
    want = {k: v for k, v in train_kernel_launches(cfg, TRAIN_ACCUM).items() if v}
    sites = {"encoder": ("repro_torch.models.whisper", "_encode"),
             "decoder": ("repro_torch.models.whisper", "_dec_block"),
             "cross": ("repro_torch.models.whisper", "_cross_attend")} if cfg.family == "audio" else {}
    log(f"training {arch}: {n_params / 1e6:.1f} M params, {len(named)} leaves, batch {rows} x {TRAIN_SEQ} in "
        f"{TRAIN_ACCUM} micro-batches, cuts: {'; '.join(cuts)}; kernels a step {want}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, step_ms, launched, by_site = [], [], [], []
    for i in range(steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        zero_launch_counts()
        with warnings.catch_warnings(record=True) as caught, flash_site_counts(sites) as site_counts:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                s.record()
                model, state, m = step(model, state, batch)
                e.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts = launch_counts()
        syncs = [f"{Path(w.filename).name}:{w.lineno} {str(w.message).splitlines()[0]}" for w in caught
                 if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
        torch.cuda.synchronize()  # the step's end: its metrics are read here
        hist.append({k: float(v) for k, v in m.items()})
        step_ms.append(s.elapsed_time(e))
        launched.append({k: v for k, v in counts.items() if v})
        by_site.append(dict(site_counts))
        log(f"training {arch} step {i + 1}: loss {hist[-1]['loss']:.5f} (z {hist[-1]['zloss']:.5f}, accuracy "
            f"{hist[-1]['accuracy']:.5f}), grad_norm {hist[-1]['grad_norm']:.4f}, {step_ms[-1]:.1f} ms "
            f"(device timeline), launches {launched[-1]}{f' by site {by_site[-1]}' if sites else ''}, "
            f"sync warnings {len(syncs)} {syncs[:2]}")
        assert not syncs, syncs
        assert launched[-1] == want, (launched[-1], want)
        assert np.isfinite(hist[-1]["loss"]) and np.isfinite(hist[-1]["grad_norm"]), hist[-1]
    assert hist[-1]["loss"] < hist[0]["loss"], [h["loss"] for h in hist]
    peak = torch.cuda.max_memory_allocated()
    tokens = rows * TRAIN_SEQ
    steady = float(np.median(step_ms[1:]))
    # one more step under the profiler
    torch.cuda.synchronize()
    with annotated(TRAIN_RANGES), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model, state, m = step(model, state, batch)
        torch.cuda.synchronize()
    dev_us = lambda ev: getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
    avgs = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA" and dev_us(ev) > 0
            and not ev.key.startswith("train.")]
    busy = sum(dev_us(ev) for ev in avgs) / 1e3
    top = sorted(avgs, key=dev_us, reverse=True)[:8]
    device_ms = {k: sum(dev_us(ev) for ev in avgs if key in ev.key) / 1e3
                 for k, key in KERNEL_KEYS.items() if k in want}
    labels = set(TRAIN_RANGES.values())
    device_ms.update({lab.split(".")[1]: range_device_ms(prof, lab) for lab in labels if lab != "train.fused_ce"})
    if "flash_attention" in want:
        device_ms["attention_bwd_products"] = range_device_ms(prof, "train.attention_bwd", ("aten::mm", "aten::bmm"))
    # the fused CE: its chunks' forward and remat recompute, and the
    # backward nodes of the forward's ops
    device_ms["fused_ce"] = range_device_ms(prof, "train.fused_ce", backward=True)
    shares = {k: v / busy for k, v in device_ms.items()}
    r = {"losses": [h_["loss"] for h_ in hist], "grad_norms": [h_["grad_norm"] for h_ in hist],
         "step_ms": step_ms, "steady_step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
         "peak_bytes": peak, "held_before_bytes": held, "busy_ms": busy, "idle_share": 1 - busy / steady,
         "launches_per_step": launched, "device_ms": device_ms, "shares": shares, "params_m": n_params / 1e6,
         "cuts": cuts, "rows": rows, "steps": steps, **({"flash_by_site": by_site} if sites else {})}
    log(f"training {arch} [{card}]: losses {r['losses']}; grad_norms {r['grad_norms']}")
    log(f"training {arch} [{card}]: step {steady:.1f} ms (median of steps 2-{steps}, device timeline; step 1 "
        f"{step_ms[0]:.1f} ms), {r['tokens_per_s']:.0f} tokens/s, peak device memory {peak / 2**30:.2f} GiB "
        f"({(peak - held) / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB earlier phases hold), device busy "
        f"{busy:.1f} ms a profiled step (idle share {r['idle_share']:.4f})")
    log(f"training {arch} [{card}]: device-busy shares " + "; ".join(
        f"{k} {v:.4f}" for k, v in shares.items()) + f" (ms: {device_ms})")
    log(f"training {arch} [{card}]: top kernels of the profiled step: " + "; ".join(
        f"{ev.key[:60]} {dev_us(ev) / 1e3:.1f} ms" for ev in top))
    del model, state, batch, named, prof
    gc.collect()
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# phase 9: the trainer on the card: a crash, a restore and a resume, bit for bit


# full-width smollm-360m through ``runtime.Trainer``: SyntheticCorpus
# sequences of TRAINER_SEQ tokens through ShardedLoader, TRAINER_BATCH of
# them a step in one micro-batch, AdamW (lr TRAIN_LR, clip_norm 1.0),
# random seed-0 weights. The phase runs in a child process whose
# environment alone sets CUBLAS_WORKSPACE_CONFIG (cuBLAS's deterministic
# workspace) and which turns on deterministic algorithms before any CUDA
# work: phases 1-8 keep cuBLAS's default workspace and their times.
TRAINER_ARCH, TRAINER_SEQ, TRAINER_BATCH = "smollm-360m", 1024, 8
TRAINER_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
TRAINER_CHILD = "--trainer-child"  # the child's one argument
TRAINER_RESULT = "trainer phase result: "  # the child's last line, read by the parent


def trainer_phase() -> dict:
    """Phase 9 in a child process (``trainer_child``, ``_child_phase``)."""
    return _child_phase(TRAINER_CHILD, TRAINER_RESULT, "phase 9")


def trainer_child():
    """The child of phase 9: deterministic algorithms on before any CUDA
    work, then ``trainer_crash_resume``; its result is printed last."""
    _deterministic_child()
    print(TRAINER_RESULT + json.dumps(trainer_crash_resume(card_name())), flush=True)


@contextlib.contextmanager
def timed_checkpoints(times: dict):
    """Host seconds of every checkpoint snapshot (the device-to-host copy
    the train loop waits for), write (a background one included) and
    restore, appended to ``times``; the manager itself unchanged."""
    from repro_torch.checkpoint.manager import CheckpointManager

    saved = {name: getattr(CheckpointManager, name) for name in ("_snapshot", "_write", "restore")}

    def timed(name, fn):
        def inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times[name.lstrip("_")].append(time.perf_counter() - t0)
        return inner

    for name, fn in saved.items():
        setattr(CheckpointManager, name, timed(name, fn))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(CheckpointManager, name, fn)


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


def trainer_crash_resume(card: str) -> dict:
    """The reference's ``test_crash_resume_bitwise`` at full width on the
    card: trainer A (checkpoints every 2 steps) crashes after step 3;
    trainer B, fresh over the same directory, restores step 2 and runs to
    step 4; trainer C runs 4 steps clean. Every parameter and AdamW leaf of
    B and C must be ``torch.equal``, and B's losses C's. Every step
    launches B5 exactly ``train_kernel_launches(cfg, 1)`` times (the counts
    zeroed before each run and read after each step). Then the launcher
    (``repro_torch.launch.train.main``) starts fresh for 2 steps and
    resumes for a third, and its last ``meta.json`` is read back. Each
    run's checkpoint directory is deleted once checked."""
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticCorpus
    from repro_torch.launch import train as launch_train
    from repro_torch.models.api import get_model, train_kernel_launches, trainable
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaf_order
    from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config(TRAINER_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == \
        TRAIN_WIDTHS[TRAINER_ARCH] and cfg.grad_accum == 1 and cfg.remat, cfg
    assert torch.are_deterministic_algorithms_enabled()
    api = get_model(cfg)
    want = {k: v for k, v in train_kernel_launches(cfg, 1).items() if v}
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=TRAINER_SEQ)
    opt = AdamWConfig(lr=TRAIN_LR, clip_norm=1.0)
    times = {"snapshot": [], "write": [], "restore": []}
    step_ms, launched, draws = {}, [], []

    def trainer(ckpt_dir: Path, label: str):
        tr = Trainer(api, opt, TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2), device="cuda")
        step_fn, step_ms[label] = tr.train_step, []

        def device_timed(*args):  # the step's device timeline, read after the run
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = step_fn(*args)
            e.record()
            step_ms[label].append((s, e))
            return out

        tr.train_step = device_timed
        return tr

    def run(tr, n_steps: int, **kw):
        loader = ShardedLoader(corpus, global_batch=TRAINER_BATCH, start_step=tr.step)
        zero_launch_counts()

        def counted(step, metrics):
            launched.append({k: v for k, v in launch_counts().items() if v})
            zero_launch_counts()

        try:
            return tr.run(loader, n_steps, on_step=counted, **kw)
        finally:
            loader.close()

    def drawn(tr, restore: bool = False):
        t0 = time.perf_counter()
        ok = tr.try_restore() if restore else tr.init_state(0)
        draws.append(time.perf_counter() - t0)
        return ok

    with tempfile.TemporaryDirectory(prefix="repro_trainer_") as tmp, timed_checkpoints(times):
        tmp = Path(tmp)
        a = trainer(tmp / "crash", "A")
        drawn(a)
        named = trainable(a.params)
        n_params = sum(p.numel() for p in named.values())
        n_leaves = 3 * len(leaf_order(named)) + 1  # the checkpoint's: parameters, m, v (a stack one leaf), step
        assert n_leaves == 34, n_leaves
        ckpt_bytes = 3 * 4 * n_params + 4  # f32 params, m and v, the int32 step (before the .npy headers)
        free = shutil.disk_usage(tmp).free
        log(f"trainer {TRAINER_ARCH}: {n_params / 1e6:.1f} M params in {len(named)} tensors, {n_leaves} "
            f"checkpoint leaves; checkpoints of {ckpt_bytes / 1e9:.3f} GB, 2 at once in a run's directory; "
            f"{free / 1e9:.1f} GB free in {tmp}")
        if free < 2 * ckpt_bytes + 2**30:
            raise RuntimeError(f"phase 9 needs {2 * ckpt_bytes + 2**30} bytes free for two checkpoints and a "
                               f"margin in {tmp}; {free} bytes are free")
        try:
            run(a, 4, fail_at=3)
            raise AssertionError("trainer A did not crash")
        except SimulatedFailure as e:
            log(f"trainer A: {e}")
        a.ckpt.wait()
        assert a.step == 3 and a.ckpt.latest_step() == 2, (a.step, a.ckpt.latest_step())
        losses = {"A": [m["loss"] for m in a.metrics_log]}
        host_s = {"A": [m["dt"] for m in a.metrics_log]}
        del a, named
        gc.collect()
        torch.cuda.empty_cache()
        b = trainer(tmp / "crash", "B")
        assert drawn(b, restore=True) and b.step == 2, b.step
        run(b, 4 - b.step)
        assert b.step == 4 and b.ckpt.latest_step() == 4
        ckpt_dir_bytes = _dir_bytes(tmp / "crash" / "step_00000004")
        n_files = len(list((tmp / "crash" / "step_00000004").iterdir()))
        shutil.rmtree(tmp / "crash")
        c = trainer(tmp / "clean", "C")
        drawn(c)
        run(c, 4)
        shutil.rmtree(tmp / "clean")
        losses.update(B=[m["loss"] for m in b.metrics_log], C=[m["loss"] for m in c.metrics_log])
        leaves = {f"params.{n}": (t, c.params.state_dict()[n]) for n, t in b.params.state_dict().items()}
        for k in ("m", "v"):
            leaves.update({f"{k}.{n}": (t, c.opt_state[k][n]) for n, t in b.opt_state[k].items()})
        leaves["step"] = (b.opt_state["step"], c.opt_state["step"])
        unequal = [n for n, (x, y) in leaves.items() if not torch.equal(x, y)]
        log(f"trainer B (resumed at step 2) against C (clean) at step 4: {len(leaves) - len(unequal)} of "
            f"{len(leaves)} leaves equal; losses A {losses['A']}, B {losses['B']}, C {losses['C']}")
        assert not unequal, unequal[:8]
        assert int(b.opt_state["step"]) == 4 and losses["B"] == losses["C"][2:] and losses["A"] == losses["C"][:3]
        assert all(x.device.type == "cuda" for x, _ in leaves.values())
        host_s.update(B=[m["dt"] for m in b.metrics_log], C=[m["dt"] for m in c.metrics_log])
        del b, c, leaves
        gc.collect()
        torch.cuda.empty_cache()

        # the launcher: fresh for 2 steps, then resumed for a third
        runs = []
        for steps in (2, 3):
            zero_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = launch_train.main(["--arch", TRAINER_ARCH, "--steps", str(steps), "--global-batch",
                                        str(TRAINER_BATCH), "--seq-len", str(TRAINER_SEQ), "--ckpt-every", "100",
                                        "--log-every", "1", "--ckpt-dir", str(tmp / "launch")])
            runs.append({"steps": steps, "rc": rc, "s": time.perf_counter() - t0,
                         "launches": {k: v for k, v in launch_counts().items() if v}, "out": out.getvalue()})
            for line in out.getvalue().splitlines():
                log(f"launcher: {line}")
        assert "[train] fresh start: smollm-360m" in runs[0]["out"] and "[train] done: step 2" in runs[0]["out"]
        assert "[train] resumed from step 2" in runs[1]["out"] and "[train] done: step 3" in runs[1]["out"]
        assert [r["rc"] for r in runs] == [0, 0]
        assert [r["launches"] for r in runs] == [{k: 2 * v for k, v in want.items()}, want], runs
        meta = json.loads((tmp / "launch" / "step_00000003" / "meta.json").read_text())
        assert (meta["step"], meta["n_leaves"], meta["extras"]) == (3, n_leaves, {"step": 3}), meta
        assert meta["dtypes"] == ["float32"] * 22 + ["int32"] + ["float32"] * 11, meta["dtypes"]
        assert sorted(os.listdir(tmp / "launch")) == ["step_00000002", "step_00000003"]
        shutil.rmtree(tmp / "launch")

    torch.cuda.synchronize()
    device_ms = {label: [s.elapsed_time(e) for s, e in ev] for label, ev in step_ms.items()}
    assert all(n == want for n in launched), launched
    r = {"card": card, "arch": TRAINER_ARCH, "tokens_a_step": [TRAINER_BATCH, TRAINER_SEQ],
         "params_m": n_params / 1e6, "ckpt_bytes": ckpt_dir_bytes, "ckpt_files": n_files,
         "step_device_ms": device_ms, "step_host_s": host_s, "snapshot_s": times["snapshot"],
         "write_s": times["write"], "restore_s": times["restore"], "weight_draw_s": draws,
         "launches_per_step": launched[0], "trainer_steps": len(launched),
         "launches": sum(n.get("flash_attention", 0) for n in launched) + sum(
             r_["launches"].get("flash_attention", 0) for r_ in runs),
         "launcher_s": [r_["s"] for r_ in runs], "losses": losses, "ckpt_leaves": n_leaves,
         "phase_s": time.perf_counter() - t_phase}
    log(f"trainer [{card}]: step device ms {device_ms}; host s (the Trainer's clock) {host_s}")
    log(f"trainer [{card}]: checkpoint {ckpt_dir_bytes} bytes in {n_files} files; snapshot s {times['snapshot']}; "
        f"write s {times['write']}; restore s {times['restore']}; weight draws s {draws}")
    return r


# ---------------------------------------------------------------------------
# phase 10: the launch layer on the card (repro_torch.launch)

# the serving launcher: full-width smollm-360m on 16 Web1-profile requests,
# its near tier 0.5% of the pages so that the far tier serves reads too
LAUNCHER_ARGS = ["--arch", "smollm-360m", "--workload", "Web1", "--requests", "16", "--near-frac", "0.005",
                 "--device", "cuda"]
# the walk's peak live bytes over the step's measured rise in
# torch.cuda.max_memory_allocated (the caching allocator rounds each block
# up; the walk counts storages as they are)
PEAK_RATIO = (0.67, 1.5)
WALK_DECODE_LENGTH = 1000  # the decode step's cache is filled to this length on the card


def launcher_phase() -> dict:
    """10a: ``launch.serve.main`` at full width, as a user runs it. Its report
    is parsed: every request finished, both tiers served reads (the near-hit
    rate strictly between 0 and 1), the page-table line printed; the
    tiered lookup (B1), flash (B5) and paged (B4) kernels launched."""
    import io
    import re

    from repro_torch.launch import serve as launch_serve

    zero_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(LAUNCHER_ARGS)
    out = buf.getvalue()
    launched = {k: v for k, v in launch_counts().items() if v}
    for line in out.splitlines():
        log(f"  [launcher] {line}")
    head = re.search(r": (\d+) requests, (\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s\)", out)
    near = float(re.search(r"near_hit_rate\s+([\d.]+)", out).group(1))
    r = {"args": LAUNCHER_ARGS, "requests_finished": int(head.group(1)), "tokens": int(head.group(2)),
         "seconds": float(head.group(3)), "tokens_per_s": float(head.group(4)), "near_hit_rate": near,
         "launches": launched}
    log(f"launcher: {r}")
    assert rc == 0 and r["requests_finished"] == 16 and "page table:" in out, r
    assert 0.0 < near < 1.0, f"the launcher's reads did not reach both tiers: near_hit_rate {near}"
    assert all(launched.get(k, 0) > 0 for k in ("tiered_segmented", "flash_attention", "paged_attention")), launched
    return r


def walk_step(api, kind: str, device: str):
    """(step, args) of phase 10b's ``kind`` of step of ``api``'s model on
    ``device`` (meta or the card): "train", one train step at phase 9's 8 x
    1,024 tokens, or "decode", one whole-batch decode step of 8 slots over
    a 1,024 cache. On the card the parameters are seed-0 draws, the tokens
    seed-3 draws and the cache filled to ``WALK_DECODE_LENGTH``."""
    import torch

    from repro_torch.models.api import make_serve_step, make_train_step, trainable
    from repro_torch.optim import AdamWConfig, adamw_init

    meta = device == "meta"
    params = api.abstract_params() if meta else api.init(0, device=device)
    g = torch.Generator().manual_seed(3)
    toks = lambda *shape: (torch.empty(shape, dtype=torch.int32, device="meta") if meta else
                           torch.randint(0, api.cfg.vocab_size, shape, generator=g, dtype=torch.int32).to(device))
    if kind == "train":
        state = adamw_init({n: p.detach() for n, p in trainable(params).items()})
        batch = {"tokens": toks(TRAINER_BATCH, TRAINER_SEQ), "labels": toks(TRAINER_BATCH, TRAINER_SEQ)}
        return make_train_step(api, AdamWConfig(lr=TRAIN_LR, clip_norm=1.0)), (params, state, batch)
    cache = api.abstract_cache(8, 1024) if meta else api.init_cache(8, 1024, device=device)
    if not meta:
        cache["lengths"].fill_(WALK_DECODE_LENGTH)
    return make_serve_step(api, vocab=api.cfg.vocab_size), (params, cache, toks(8, 1))


def walk_vs_card(card: str) -> dict:
    """10b: the cost walk against the card, for full-width smollm-360m's
    train step (phase 9's 8 x 1,024 tokens, AdamW) and a whole-batch decode
    step (8 slots over a 1,024 cache). Each step is walked on meta
    (``launch.op_analysis.walk``; the decode walked once before, for its
    held casts, as the card's step runs after one warm-up step), then run
    on the card from seed-0 weights, once to warm up and once measured
    with CUDA events. Held: the walk's peak live bytes within
    ``PEAK_RATIO`` of the step's rise in ``max_memory_allocated`` over what
    the card held before its weights were made; the measured device time at
    or above the walk's bound, max(compute_s, memory_s) at the card's
    peaks; the kernels the walk recorded equal to the wrappers'
    ``LAUNCHES`` rise in the measured step, kernel by kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis, roofline as rl
    from repro_torch.models.api import get_model

    cfg = get_config("smollm-360m")
    api = get_model(cfg)
    out = {}
    for kind, tokens in (("train", TRAINER_BATCH * TRAINER_SEQ), ("decode", 8)):
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        step, args = walk_step(api, kind, "meta")
        t0 = time.perf_counter()
        with grad:
            if kind == "decode":
                op_analysis.walk(step, *args)
            _, cost = op_analysis.walk(step, *args)
        walk_s = time.perf_counter() - t0
        terms = rl.roofline(cost=cost, n_params=float(cfg.n_params()), n_tokens=float(tokens),
                            kind="train" if kind == "train" else "serve")
        bound_ms = max(terms.compute_s, terms.memory_s) * 1e3
        del step, args
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        step, args = walk_step(api, kind, "cuda")
        with grad:
            step(*args)  # warm-up: cuBLAS, and the decode's held casts
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            result = step(*args)
            e.record()
            torch.cuda.synchronize()
        launched = {k: v for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() - base
        ms = s.elapsed_time(e)
        r = {"walk_peak_bytes": cost.peak_bytes, "card_peak_bytes": peak, "peak_ratio": cost.peak_bytes / peak,
             "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms, "compute_ms": terms.compute_s * 1e3,
             "memory_ms": terms.memory_s * 1e3, "compute_at_bf16_ms": terms.detail["compute_at_bf16_s"] * 1e3,
             "flops": cost.flops, "bytes": cost.bytes, "flops_by_dtype": dict(cost.flops_by_dtype),
             "walk_kernels": dict(cost.kernel_calls), "launches": launched, "walk_s": walk_s,
             "roofline_fraction": rl.roofline_fraction(terms), "ops": cost.ops}
        log(f"walk vs card, smollm-360m {kind} [{card}]: walk peak {cost.peak_bytes / 2**30:.3f} GiB, card "
            f"{peak / 2**30:.3f} GiB (ratio {r['peak_ratio']:.4f}, held to {PEAK_RATIO}); measured {ms:.3f} ms, "
            f"walk bound {bound_ms:.3f} ms (compute {r['compute_ms']:.3f}, memory {r['memory_ms']:.3f}, all "
            f"flops at bf16 {r['compute_at_bf16_ms']:.3f}; {r['bound_share']:.4f} of the measured time); kernels "
            f"walked {r['walk_kernels']}, launched {launched}; {cost.ops} aten ops walked in {walk_s:.1f} s")
        assert PEAK_RATIO[0] <= r["peak_ratio"] <= PEAK_RATIO[1], r
        assert ms >= bound_ms, f"the walk's bound {bound_ms} ms exceeds the measured {ms} ms: it overcounts"
        assert launched == dict(cost.kernel_calls), (launched, dict(cost.kernel_calls))
        out[kind] = r
        del step, args, result
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_phase() -> dict:
    """10c: ``launch.dryrun.main`` walks smollm-360m's three cells into a
    temporary directory and ``launch.report.main`` renders them."""
    import io
    import tempfile

    from repro_torch.launch import dryrun, report

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = dryrun.main(["--arch", "smollm-360m", "--mesh", "card", "--out", tmp])
        walk_s = time.perf_counter() - t0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            report.main(["--dir", tmp])
        cells = report.load(os.path.join(tmp, dryrun.MESHES["card"]))
    for line in buf.getvalue().splitlines():
        log(f"  [report] {line}")
    assert rc == 0 and len(cells) == 3 and all(c["ok"] for c in cells), [c.get("error") for c in cells]
    return {"walk_s": walk_s, "cells": {c["shape"]: {"peak_bytes": c["memory"]["peak_bytes"],
                                                      "fits": c["memory"]["fits"],
                                                      "bound": c["roofline"]["bound"],
                                                      "roofline_fraction": c["roofline"]["roofline_fraction"]}
                                        for c in cells}}


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
    mp["sharded_one"] = one
    log(f"sharded [{card}]: model_shards {list(SHARDS)} give bit-identical tokens "
        f"({one['toks'].shape[0]} steps x {one['toks'].shape[1]} slots), equal live counters, books and "
        f"merged drained planes (near {one['merged']['near']}, far {one['merged']['far']})")
    return {str(n): {k: v for k, v in r.items() if k not in ("toks", "merged", "live", "role", "books")}
            for n, r in runs.items()}


# ---------------------------------------------------------------------------
# phase 11: the sharded engine over a mesh of cards (launch.mesh): one card
# here, smollm-360m and one model of each other family; full-width
# qwen1.5-110b over 1, 2 and 4 cards and qwen2-moe-a2.7b over 2 and 4 in
# mesh_phase


MESH_ARCH = "qwen1.5-110b"
MESH_LAYERS = 4  # of its 80: 7.9 B parameters, 31.7 GB in f32, so the 1-card mesh fits one card
MESH_CARDS = (1, 2, 4)
MESH_REQUESTS = 6
MESH_CHUNK_CARDS = 2  # the dense mesh's chunked path (prefill_chunk=CHUNK) over this many cards
MOE_ARCH = "qwen2-moe-a2.7b"  # all 24 layers: 14.3 B parameters, 57.3 GB in f32, more than a card holds
MOE_CARDS = (2, 4)
# each mesh's first prefill logits against its model's 1-card bf16 run, as
# a share of the f32 logits' scale: on H100s a mesh's other order of sums
# moved them 0.0079 of it (qwen1.5-110b, 2 and 4 cards against the 1-card
# mesh) and 0.0141 / 0.0136 (qwen2-moe-a2.7b, 2 / 4 cards against the
# bf16-stored forward), a planted placement fault 0.380 (PERF.md §6)
MESH_LOGIT_TOL = 0.025
# phase 11's other families: phase 3's full-width params cut to their first
# layers (zamba2 to 6: its shared block applies after every 6th layer, so 2
# would leave it none; whisper's encoder to 2 as well)
MESH_FAMILIES = {"granite-moe-3b-a800m": 2, "qwen2-vl-7b": 2, "rwkv6-7b": 2, "zamba2-1.2b": 6,
                 "whisper-base": 2}
MESH_FAMILY_REQUESTS = 4


def cut_depth(params, cfg, layers: int):
    """(config, params) of the model cut to its first ``layers`` layers (and
    encoder layers), the params on the host: a shallow copy of the module
    sharing the kept tensors, with no held casts."""
    import torch

    stacks = ("layers", "enc_layers", "dec_layers")
    out = copy.copy(params)
    out._modules = {name: torch.nn.ModuleList(list(m)[:layers]) if name in stacks else m
                    for name, m in params._modules.items()}
    for m in out.modules():
        m.__dict__.pop("_casts", None)
    cut = dataclasses.replace(cfg, n_layers=layers, **({"n_encoder_layers": layers} if cfg.n_encoder_layers else {}))
    return cut, out.to("cpu")


def mesh_engine(api, params, mesh, n: int, chunk: int = 0):
    """A ``ShardedServingEngine`` over ``mesh`` (its parameters placed by
    ``shard_model_params``), with ``make_engine``'s cold near tier, and
    ``prefill_chunk=chunk``."""
    from repro_torch.runtime.serving import EngineConfig
    from repro_torch.runtime.sharded import ShardedServingEngine

    eng = ShardedServingEngine(api, params, EngineConfig(**ECFG, model_shards=n, prefill_chunk=chunk), seed=0,
                               mesh=mesh)
    cap = eng.placement.near_capacity
    eng.apply_placement(np.arange(eng.ecfg.n_pages - cap, eng.ecfg.n_pages))
    return eng


def mesh_books(eng) -> dict:
    """The engine's stats without the books a split store counts per shard."""
    st = eng.stats()
    return {**st, "device_tiering": {k: v for k, v in st["device_tiering"].items() if k not in SHARD_BUDGET_KEYS}}


def serve_on_one_card_mesh(api, params, reqs, mesh) -> dict:
    """``reqs`` through the sharded engine over ``mesh``, a mesh of this one
    card: its parameters placed by ``shard_model_params``, every step under
    the mesh, its dispatches eager (a mesh engine captures no graph). Its
    run (``drive``, sync-checked), launches (every one eager), books, live
    counters, role hits and dispatch counts."""
    t0 = time.perf_counter()
    eng = mesh_engine(api, params, mesh, 1)
    built = time.perf_counter() - t0
    zero_launch_counts()
    run = drive(eng, [dataclasses.replace(r) for r in reqs], quiet_check=True, step_events=True)
    assert not eng._graphs and eng.tiered.n_shards == 1
    return {"run": run, "launches": path_launches(eng, launch_counts()), "books": mesh_books(eng),
            "live": eng.live_counters(), "role": eng.role_hits.copy(), "steps": eng.engine_steps,
            "prefills": eng.prefill_dispatches, "decodes": eng.model_dispatches - eng.prefill_dispatches,
            "build_s": built}


def mesh_one_summary(card: str, label: str, m: dict, base: dict, cfg) -> dict:
    """Asserts a 1-card mesh run ``m`` (``serve_on_one_card_mesh``) bit-equal
    to ``base`` (its tokens a step, live counters, books and role hits: the
    same engine without a mesh), the model kernels once a layer a dispatch
    (``kernel_launches``), B1 once a step, and no host read in a step that
    neither drains nor admits; logs and returns the summary."""
    import torch

    from repro_torch.models.api import kernel_launches

    run, launches, q = m["run"], m["launches"], m["run"]["quiet"]
    want = kernel_launches(cfg, m["prefills"], m["decodes"])
    assert {k: launches[k] for k in want} == want, (label, launches, want)
    assert launches["tiered_segmented"] == m["steps"] == base["steps"], (label, launches, m["steps"])
    assert q["steps"] > 0 and q["reads"] == 0, (label, q)
    same = {"tokens": torch.equal(run["toks"], base["toks"]), "live": m["live"] == base["live"],
            "books": m["books"] == base["books"], "role": bool(np.array_equal(m["role"], base["role"]))}
    tokens = m["books"]["tokens_decoded"]
    res = {"steps": m["steps"], "wall_s": run["wall"], "build_s": m["build_s"], "tokens": tokens,
           "tokens_per_s": tokens / run["wall"], "step_p50_ms": pct(run["step_ms"], 50),
           "step_p99_ms": pct(run["step_ms"], 99),
           "launches": {k: launches[k] for k in (*(k for k in want if want[k]), "tiered_segmented")},
           "quiet_steps": q["steps"], "sync_warnings": len(q["syncs"]), "same": same}
    log(f"mesh [{card}] 1 card: {label}, {m['steps']} steps, {tokens} tokens, {run['wall']:.3f} s wall "
        f"({res['tokens_per_s']:.1f} tokens/s; without a mesh {base['wall']:.3f} s), step p50 "
        f"{res['step_p50_ms']:.2f} ms; launches {res['launches']}; {q['steps']} quiet steps, 0 host reads, "
        f"{len(q['syncs'])} sync warnings; equal to the engine without a mesh: {same}")
    assert all(same.values()), (label, same)
    return res


def serve_mesh_family(card: str, arch: str, cfg, params, mesh) -> dict:
    """One family's model (phase 3's params at full width cut in depth,
    ``MESH_FAMILIES``) and ``MESH_FAMILY_REQUESTS`` Web1 requests through the
    engine without a mesh (the main path's, its decode a CUDA graph), then
    through the sharded engine over the 1-card ``mesh``: bit-equal
    (``mesh_one_summary``), B4/B5 (every attention), B6 or B7 on the
    mesh's one rank."""
    import torch

    from repro_torch.models.api import get_model

    api = get_model(cfg)
    params.to("cuda")
    reqs = web1_requests(cfg, MESH_FAMILY_REQUESTS, seed=0)
    eng = make_engine(api, params, **ECFG)
    run = drive(eng, [dataclasses.replace(r) for r in reqs])
    base = {"toks": run["toks"], "wall": run["wall"], "steps": eng.engine_steps, "live": eng.live_counters(),
            "books": mesh_books(eng), "role": eng.role_hits.copy()}
    assert base["books"]["requests_finished"] == len(reqs), base["books"]["requests_finished"]
    del eng
    m = serve_on_one_card_mesh(api, params, reqs, mesh)
    layers = f"{cfg.n_layers} layers" + (f" (and {cfg.n_encoder_layers} encoder layers)" if cfg.n_encoder_layers else "")
    res = mesh_one_summary(card, f"{arch} ({cfg.family}, full width, {layers})", m, base, cfg)
    del m
    params.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_mesh_one(card: str, mp: dict, kept: dict) -> dict:
    """Phase 11, over a mesh of this one card (a 1-rank NCCL group): phase
    7's smollm-360m params and 16 Web1 requests, bit-equal to phase 7's
    1-shard engine; then each model of ``kept`` (arch -> (config, params on
    the host), one of each other family), bit-equal to the same engine
    without a mesh (``serve_mesh_family``)."""
    import tempfile

    import torch

    from repro_torch.launch import mesh as meshlib

    api, params, cfg, reqs, one = mp["api"], mp["params"], mp["cfg"], mp["reqs"], mp["sharded_one"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        meshlib.init_process_group(rank=0, world_size=1, store=f"{tmp}/store", backend="nccl")
        try:
            mesh = meshlib.make_serving_mesh(1)
            m = serve_on_one_card_mesh(api, params, reqs, mesh)
            out["smollm-360m"] = mesh_one_summary(card, "smollm-360m (phase 7's params)", m, one, cfg)
            del m
            for arch, (cut, cut_params) in kept.items():
                t = time.perf_counter()
                out[arch] = serve_mesh_family(card, arch, cut, cut_params, mesh)
                out[arch]["phase_s"] = time.perf_counter() - t
        finally:
            torch.distributed.destroy_process_group()
    return out


def _margins(api, log_: list):
    """Wrap ``api``'s prefill and decode so each records its last
    position's top-2 logit margin (on the device, read after the run)."""
    import torch

    from repro_torch.launch.mesh import whole

    for name in ("prefill", "decode"):
        orig = getattr(api, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            logits, cache = _orig(*a, **k)
            top = torch.topk(whole(logits)[:, -1, : api.cfg.vocab_size].float(), 2, dim=-1).values
            log_.append((_name, top[:, 0] - top[:, 1]))
            return logits, cache

        setattr(api, name, wrapped)


def _serve_on_mesh(api, cfg, params, reqs, mesh, n: int, chunk: int = 0) -> dict:
    """``mesh_phase``'s run on one rank of an ``n``-card mesh: the engine
    (``prefill_chunk=chunk``) over ``reqs`` (each dispatch's top-2 logit
    margins recorded), then one prefill's logits and 3 whole-batch decode
    steps timed, 3 profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import kernel_launches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = mesh_engine(api, params, mesh, n, chunk)
    placed = time.perf_counter() - t0
    local_bytes = sum(meshlib.local(p).numel() * p.element_size() for p in eng.params.parameters())
    margins = []
    _margins(api, margins)
    step = eng.step

    def marked():
        margins.append(("step", None))
        return step()

    eng.step = marked
    zero_launch_counts()
    try:
        run = drive(eng, [dataclasses.replace(r) for r in reqs], step_events=True)
    finally:
        for name in ("prefill", "decode"):
            delattr(api, name)
    launches = launch_counts()
    per_step = []
    for kind, m in margins:
        if kind == "step":
            per_step.append([])
        else:
            per_step[-1].append((kind, m.cpu().numpy()))
    peak = torch.cuda.max_memory_allocated()
    books = mesh_books(eng)
    decodes = eng.batch_decodes  # a decode step's, and on the chunked path a chunk column's
    want = kernel_launches(cfg, eng.prefill_dispatches, decodes)
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert eng.chunking == bool(chunk) and (eng.prefill_dispatches == 0) == bool(chunk), eng.prefill_dispatches
    # one prefill's logits at the last prompt position, gathered whole
    with torch.no_grad(), meshlib.activate(mesh):
        logits, _ = api.prefill(eng.params, eng._prefill_batch(reqs[0].tokens), max_len=ECFG["max_len"])
        first = meshlib.whole(logits)[0, -1].float().cpu()

    def run_decodes(k):
        with meshlib.activate(mesh):
            for _ in range(k):
                eng._decode_fn(eng._bufs)
        torch.cuda.synchronize()

    run_decodes(1)
    t1 = time.perf_counter()
    run_decodes(3)
    host_ms = (time.perf_counter() - t1) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_decodes(3)
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    avgs = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in avgs) / 1e3 / 3
    comm = sum(dev_us(e) for e in avgs if "nccl" in e.key.lower()) / 1e3 / 3
    return {  # numpy, not tensors: they cross to the parent by pickle
        "tokens": run["toks"].numpy(), "books": books, "margins": per_step, "first_logits": first.numpy(),
        "launches": {k: launches[k] for k in (*want, "tiered_segmented")},
        "steps": eng.engine_steps, "prefills": eng.prefill_dispatches, "decodes": decodes,
        "columns": eng.chunk_columns,
        "wall_s": run["wall"], "tokens_per_s": books["tokens_decoded"] / run["wall"],
        "step_p50_ms": pct(run["step_ms"], 50), "step_p99_ms": pct(run["step_ms"], 99),
        "decode_host_ms": host_ms, "decode_busy_ms": busy, "decode_comm_ms": comm,
        "peak_gib": peak / 2**30, "param_gib": local_bytes / 2**30, "place_s": placed,
    }


def _f32_logits(cfg, params, tokens) -> np.ndarray:
    """The model's f32 forward on this rank's card: one prefill of
    ``tokens``, the last position's logits (the params move to the card and
    back to the host, in place)."""
    import torch

    from repro_torch.models.api import get_model

    f32 = get_model(dataclasses.replace(cfg, compute_dtype="float32"))
    params.to("cuda")
    with torch.no_grad():
        logits, _ = f32.prefill(params, {"tokens": torch.as_tensor(tokens, device="cuda")[None]},
                                max_len=ECFG["max_len"])
    out = logits[0, -1].float().cpu().numpy()
    del logits
    params.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _bf16_logits(cfg, params, tokens, planted: bool = False) -> np.ndarray:
    """The model on this one card with every leaf stored as its bf16 cast
    (the values a mesh computes with; 28.6 GB for qwen2-moe-a2.7b, where
    the f32 leaves and their casts would not fit): one prefill of
    ``tokens``, the last position's logits. The same products as a 1-card
    mesh, the reference a model too large for one card's f32 leaves holds
    its meshes to. ``planted``: layer 0's expert down-projections with
    their hidden rows rolled by half, what a rank of a 2-card mesh computes
    if it paired its half of the expert hidden dim in ``w_gate``/``w_up``
    with the other rank's half in ``w_down`` (a placement fault the
    meshes' check must see)."""
    import torch

    from repro_torch.models.api import get_model

    memo = {id(p): torch.nn.Parameter(p.detach().to("cuda", torch.bfloat16), requires_grad=False)
            for p in params.parameters()}
    for m in params.modules():
        if "_casts" in m.__dict__:
            memo[id(m.__dict__["_casts"])] = {}
    bf = copy.deepcopy(params, memo)
    if planted:
        w = bf.layers[0].experts.w_down
        w.data = w.data.roll(w.shape[1] // 2, dims=1)
    with torch.no_grad():
        logits, _ = get_model(cfg).prefill(bf, {"tokens": torch.as_tensor(tokens, device="cuda")[None]},
                                           max_len=ECFG["max_len"])
    out = logits[0, -1].float().cpu().numpy()
    del logits, bf, memo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_models(world: int) -> list:
    """``mesh_phase``'s runs: (arch, layers kept or None, card counts, card
    counts of its chunked path), each count at most ``world``."""
    fit = lambda cards: tuple(n for n in cards if n <= world)
    return [(MESH_ARCH, MESH_LAYERS, fit(MESH_CARDS), fit((MESH_CHUNK_CARDS,))), (MOE_ARCH, None, fit(MOE_CARDS), ())]


def _mesh_rank(rank: int, world: int, store: str, out):
    """One NCCL rank of ``mesh_phase``: each model of ``_mesh_models`` drawn
    on the rank's card once at full width (qwen1.5-110b cut to
    ``MESH_LAYERS`` layers, qwen2-moe-a2.7b whole) and kept on the host,
    served over its meshes in turn (a rank outside a mesh waits at the
    barrier), whole-slot and then on the chunked path. Rank 0 first runs
    one prefill of each model in f32 on its card, the reference the
    meshes' bf16 logits are held to, and for a model with no 1-card mesh
    the same prefill bf16-stored, with and without a planted fault."""
    import traceback

    try:
        import torch

        sys.path.insert(0, str(SRC))
        torch.set_num_threads(8)
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs import get_config
        from repro_torch.launch import mesh as meshlib
        from repro_torch.models.api import get_model

        meshlib.init_process_group(rank=rank, world_size=world, store=store, backend="nccl")
        runs = _mesh_models(world)
        # making a sub-mesh is collective: every rank makes each once, in one order
        meshes = {n: meshlib.make_serving_mesh(n) for n in sorted({n for r in runs for n in r[2] + r[3]})}
        res = {}
        for arch, layers, cards, chunked in runs:
            # the shipped config: qwen1.5-110b's sp_activations split each
            # prefill's queries over the cards (B5 at each rank's first row)
            cfg = dataclasses.replace(get_config(arch), **({"n_layers": layers} if layers else {}))
            api = get_model(cfg)
            t0 = time.perf_counter()
            params = draw_on_card(api).to("cpu")  # the same values on every rank's card
            torch.cuda.empty_cache()
            r = res[arch] = {"draw_s": time.perf_counter() - t0, "params": sum(p.numel() for p in params.parameters())}
            log(f"mesh rank {rank}: {arch} drawn in {r['draw_s']:.1f} s")
            reqs = web1_requests(cfg, MESH_REQUESTS, seed=0)
            if rank == 0:
                r["f32_logits"] = _f32_logits(cfg, params, reqs[0].tokens)
                if 1 not in cards:  # no 1-card mesh: its products in bf16 on one card instead
                    r["bf16_logits"] = _bf16_logits(cfg, params, reqs[0].tokens)
                    r["planted_logits"] = _bf16_logits(cfg, params, reqs[0].tokens, planted=True)
            for key, n, chunk in [(n, n, 0) for n in cards] + [(f"{n} chunked", n, CHUNK) for n in chunked]:
                if meshlib.in_mesh(meshes[n]):
                    r[key] = _serve_on_mesh(api, cfg, params, reqs, meshes[n], n, chunk)
                    log(f"mesh rank {rank}: {arch} over {key} card(s): {r[key]['steps']} steps, "
                        f"{r[key]['wall_s']:.1f} s wall, peak {r[key]['peak_gib']:.2f} GiB")
                    gc.collect()
                    torch.cuda.empty_cache()
                torch.distributed.barrier()
            del params
            gc.collect()
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent raises it
        out.put((rank, {"error": traceback.format_exc()}))


def _mesh_summary(card: str, arch: str, got: dict, cards: tuple, chunked: tuple) -> dict:
    """``mesh_phase``'s checks and report of one model (``got``: rank -> its
    runs). Asserts: every rank of a mesh gives the same tokens and books;
    the books equal across meshes and every request finished; every
    mesh's first prefill logits no farther from the f32 forward than 4
    times the 1-card bf16 run's (the 1-card mesh, or for a model no card
    holds in f32 with its casts, ``_bf16_logits``), and within
    ``MESH_LOGIT_TOL`` of the f32 logits' scale of that 1-card run's, where
    the planted fault's logits must land outside. The chunked runs: every
    rank's tokens and books the same, every request finished, no prefill
    dispatch."""
    import torch

    base = got[0][cards[0]]
    ref = got[0]["f32_logits"]
    one = got[0]["bf16_logits"] if "bf16_logits" in got[0] else base["first_logits"]
    scale = float(np.abs(ref).max())
    off = lambda logits: float(np.abs(logits - ref).max())
    off_one = lambda logits: float(np.abs(logits - one).max())
    summary = {"draw_s": got[0]["draw_s"], "params": got[0]["params"], "f32_logits_scale": scale,
               "one_card_bf16_off_f32": off(one), "one_card_bound": MESH_LOGIT_TOL * scale}
    if "planted_logits" in got[0]:
        summary["planted_off_one_card"] = off_one(got[0]["planted_logits"])
    if 1 not in cards:
        log(f"mesh [{card}] {arch}: not on 1 card, which cannot hold its {got[0]['params'] * 4 / 1e9:.1f} GB of "
            f"f32 parameters and their bf16 casts; its 1-card reference is a bf16-stored forward")
    keep = ("steps", "prefills", "decodes", "columns", "wall_s", "tokens_per_s", "step_p50_ms", "step_p99_ms",
            "decode_host_ms", "decode_busy_ms", "decode_comm_ms", "place_s")
    for key, n in [(n, n) for n in cards] + [(f"{n} chunked", n) for n in chunked]:
        runs = [got[r][key] for r in range(n)]
        for r in runs[1:]:
            assert np.array_equal(r["tokens"], runs[0]["tokens"]) and r["books"] == runs[0]["books"], (arch, key)
        r0 = runs[0]
        assert r0["books"]["requests_finished"] == MESH_REQUESTS, (arch, key, r0["books"]["requests_finished"])
        row = {**{k: r0[k] for k in keep}, "peak_gib_per_card": [r["peak_gib"] for r in runs],
               "param_gib_per_card": [r["param_gib"] for r in runs],
               "launches_per_rank": [r["launches"] for r in runs],
               "comm_share": r0["decode_comm_ms"] / max(r0["decode_busy_ms"], 1e-9)}
        if key == n:
            assert r0["books"] == base["books"], (arch, n)
            close = within_one_bf16_step(torch.from_numpy(r0["first_logits"]),
                                         torch.from_numpy(base["first_logits"]))
            diverge = None
            if not np.array_equal(r0["tokens"], base["tokens"]):
                step, slot = (int(i) for i in np.argwhere(r0["tokens"] != base["tokens"])[0])
                # the top-2 logit margins of the divergent step's dispatches (a
                # decode's at the slot, an admit's prefill), there and on the fewest cards
                diverge = {"step": step, "slot": slot, "margins": {
                    label: [float(m[slot] if kind == "decode" else m[0]) for kind, m in r["margins"][step]]
                    for label, r in ((str(cards[0]), base), (str(n), r0))}}
            row.update({"tokens_equal": diverge is None, "first_divergence": diverge,
                        "first_logits_max_abs_diff": float(np.abs(r0["first_logits"] - base["first_logits"]).max()),
                        "first_logits_within_one_bf16_step": close, "first_logits_off_f32": off(r0["first_logits"]),
                        "first_logits_off_one_card": off_one(r0["first_logits"]),
                        "first_logits_within_one_bf16_step_of_one_card": within_one_bf16_step(
                            torch.from_numpy(r0["first_logits"]), torch.from_numpy(one))})
        else:
            assert r0["prefills"] == 0 and r0["columns"] > 0, (arch, key, r0["prefills"], r0["columns"])
        summary[str(key)] = row
        log(f"mesh [{card}] {arch} over {key} card(s): " + json.dumps(row))
    log(f"mesh [{card}] {arch}: " + json.dumps({k: v for k, v in summary.items() if not isinstance(v, dict)}))
    # bf16 compute: the partial sums of the row-split products are added in
    # another order, which moves a rare bf16 rounding of the residual (and in
    # a moe model may flip a near-tied expert choice); so the meshes' logits
    # are held to the f32 forward, no farther from it than 4 times the
    # 1-card bf16 run's distance, and to that 1-card run itself within
    # MESH_LOGIT_TOL of the scale, which the planted fault must exceed
    bound = summary["one_card_bound"]
    for n in cards:
        assert off(got[0][n]["first_logits"]) <= 4 * off(one), (arch, n, off(got[0][n]["first_logits"]), off(one))
        assert off_one(got[0][n]["first_logits"]) <= bound, (arch, n, off_one(got[0][n]["first_logits"]), bound)
    if "planted_logits" in got[0]:
        assert summary["planted_off_one_card"] > bound, (arch, summary["planted_off_one_card"], bound)
    return summary


def mesh_phase(card: str, world: int = 4) -> dict:
    """Serving across cards at full width, one NCCL rank a card meeting at a
    file store, the same 6 Web1 requests everywhere: qwen1.5-110b (d 8,192,
    64/8 heads of 128, d_ff 49,152, vocab 152,064, QKV bias; its shipped
    ``sp_activations``: each prefill's queries split over the cards) cut to
    ``MESH_LAYERS`` of its 80 layers over meshes of 1, 2 and 4 cards, and
    its chunked path (``prefill_chunk=CHUNK``) over 2; then qwen2-moe-a2.7b
    (24 layers, d 2,048, 16 heads of 128, 60 experts top-4 of d_ff 1,408
    and 4 shared, vocab 151,936: 57.3 GB in f32, more than one card holds,
    so not on 1) over 2 and 4, its experts TP-for-MoE (their hidden dim
    over the cards). Parameters placed by ``shard_model_params``, B5 and
    B4 on each card's own heads, B1 on each card's own store shard. The
    checks are ``_mesh_summary``'s; every rank's launches are held in
    ``_serve_on_mesh``. Reports whether the first logits are within one
    bf16 step of the fewest cards', the tokens' first divergence with its
    top-2 logit margins, per-card peak memory and parameter bytes, decode
    step time, device busy and the collectives' share of it (their
    kernels' time includes the wait for the slower rank), and tokens/s."""
    import multiprocessing
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(target=_mesh_rank, args=(r, world, f"{tmp}/store", out)) for r in range(world)]
        for p in procs:
            p.start()
        got = dict(out.get(timeout=1300) for _ in range(world))
        for p in procs:
            p.join(timeout=60)
    errors = [r["error"] for r in got.values() if "error" in r]
    assert not errors, errors[0]
    return {arch: _mesh_summary(card, arch, {r: got[r][arch] for r in got}, cards, chunked)
            for arch, _, cards, chunked in _mesh_models(world)}


# ---------------------------------------------------------------------------
# training across cards: phase 12 (a 1-card mesh, in the smoke) and
# train_mesh_phase (four cards, alone)

MESH_TRAIN_AXES = ("data", "pool", "model")
MESH_TRAIN_ROWS, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 8, 1024, 3  # phase 12: phase 9's 8 x 1,024
# phase 12's other families over the 1-card mesh: (arch, layers kept or None,
# rows, sequence, AdamW's lr), each at its config's grad_accum (vlm 8, zamba2
# 4, whisper 1): at 1e-3 qwen2-vl-7b's loss rose at step 3 (12.32, 9.69,
# 12.73, its grad norm 5.4 -> 35.3; run AO1b), and so did zamba2-1.2b's
# (10.78, 7.17, 11.47; AO1c), each bit-equal to its steps with no mesh
MESH_TRAIN_FAMILIES = [("qwen2-vl-7b", 2, 8, 1024, 1e-4), ("zamba2-1.2b", 6, 4, 1024, 1e-4),
                       ("whisper-base", None, 4, 1024, 1e-4)]
MESH_TRAIN_CHILD = "--mesh-train-child"  # phase 12's child's one argument
MESH_TRAIN_RESULT = "mesh train phase result: "
# train_mesh_phase's runs: (arch, layers kept or None, rows, sequence, meshes,
# AdamW's lr) at the config's own grad_accum and sp_activations. AdamW's first
# steps move every weight by about lr: at qwen1.5-110b's widths (a product
# over d_ff 49,152) 1e-3 moves a layer's output by tens of its own size, and
# the loss rose (run AM4c); its lr is cut to that of a step of ~0.15 of it.
# rwkv6-7b's 32 layers rose at 1e-4 (AM4: 11.47 -> 14.81, its grad norm 5.1
# -> 52.5), and take 1e-5; its 8 layers on one card at 1e-4 (lr_witness, run
# AN) jump the same way without a mesh as over one (grad norm 2.52 -> 38.0,
# the two runs bit-equal)
# (e), the families the reference does not pool: qwen2-vl-7b at full depth
# (8.3 B parameters, 133 GB with AdamW's state: two or four cards) at 1e-5,
# a step of ~0.15 of qwen1.5-110b's by the same reckoning from its d_ff
# 18,944; zamba2-1.2b and whisper-base at 1e-4 (phase 12's: zamba2's loss
# rose at 1e-3 there), each also taking one step with no mesh on rank 0's
# card (``TRAIN_MESH_PLAIN``)
TRAIN_MESH_RUNS = [
    ("qwen1.5-110b", 4, 4, 2048, ((1, 4, 1), (1, 1, 4), (1, 2, 2)), 3e-6),
    ("rwkv6-7b", None, 16, 1024, ((1, 2, 2),), 1e-5),
    ("qwen2-moe-a2.7b", 12, 8, 1024, ((1, 2, 2),), 1e-4),
    ("qwen2-vl-7b", None, 32, 512, ((1, 2, 2), (1, 4, 1)), 1e-5),
    ("zamba2-1.2b", None, 8, 1024, ((1, 2, 2),), 1e-4),
    ("whisper-base", None, 8, 1024, ((1, 2, 2),), 1e-4),
]
TRAIN_MESH_PLAIN = ("zamba2-1.2b", "whisper-base")  # held to a step with no mesh on one card
# the leaf a planted fault rolls by one row in the shard of pool rank 1, on the
# model's first mesh, for one step: each model's agreement bound must miss it
TRAIN_MESH_PLANT = {"qwen1.5-110b": "layers.0.mlp.w_up", "qwen2-vl-7b": "layers.0.mlp.w_up",
                    "zamba2-1.2b": "layers.0.w_in", "whisper-base": "enc_layers.0.mlp.w_in"}
# the walk of (a)'s step on meta against (a)'s (1, 4, 1) run: (arch, layers,
# rows, sequence, mesh), over a fake process group of the mesh's ranks
TRAIN_WALK = ("qwen1.5-110b", 4, 4, 2048, (1, 4, 1))
TRAIN_WALK_CHILD = "--train-walk-child"
TRAIN_WALK_RESULT = "train walk result: "
RESTORE_RUN = ("smollm-360m", 8, 1024, (1, 2, 2), (1, 4, 1))  # (d): trained, saved, restored elsewhere
# a model's first steps (its meshes' against each other, or its mesh's against
# the step with no mesh) agree within these (relative), each 2x the largest of
# that model's bf16 readings: qwen1.5-110b's in run AM4 (loss 1.32e-6, grad
# norm 2.11e-4; the planted fault read 6.35e-5 and 1.91e-3), qwen2-vl-7b's in
# AO4 (2.38e-5, 2.04e-4; planted 5.78e-4, 4.08e-3), zamba2-1.2b's and
# whisper-base's in AO4b (1.53e-5, 8.46e-5; 3.30e-6, 1.00e-4). Their cause is
# the bf16 compute's rounding, shown by the f32 witness below
MESH_AGREE = {"qwen1.5-110b": {"loss": 2.7e-6, "grad_norm": 4.3e-4},
              "qwen2-vl-7b": {"loss": 4.8e-5, "grad_norm": 4.1e-4},
              "zamba2-1.2b": {"loss": 3.1e-5, "grad_norm": 1.7e-4},
              "whisper-base": {"loss": 6.6e-6, "grad_norm": 2.0e-4}}
# the f32 witness: the same first steps with compute_dtype float32. Rounding
# shrinks with the compute's precision and a placement fault does not, so the
# f32 readings must fall within F32_AGREE, 30x below the smallest planted
# fault's loss reading (6.35e-5) and 48x below its grad norm (1.91e-3)
TRAIN_MESH_F32 = ("qwen2-vl-7b", "zamba2-1.2b", "whisper-base")
F32_AGREE = {"loss": 2e-6, "grad_norm": 4e-5}
GIB = 2**30


def _child_phase(arg: str, prefix: str, label: str) -> dict:
    """A phase in a child process of this script (deterministic algorithms
    on before any CUDA work, ``TRAINER_ENV``): its lines go to this log,
    its result comes back as one JSON line after ``prefix``, and a failure
    in it (a non-zero exit) raises here."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    result = None
    with subprocess.Popen([sys.executable, str(Path(__file__).resolve()), arg], cwd=ROOT,
                          env=dict(os.environ, **TRAINER_ENV), stdout=subprocess.PIPE, text=True) as proc:
        try:
            for line in proc.stdout:
                if line.startswith(prefix):
                    result = json.loads(line[len(prefix):])
                else:
                    log(f"  [{label}] {line.rstrip()}")
            rc = proc.wait(timeout=60)
        except BaseException:
            proc.kill()
            raise
    if rc != 0 or result is None:
        raise RuntimeError(f"{label}: the child process exited {rc} (result line: {result is not None})")
    return result


def _deterministic_child():
    import torch

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != TRAINER_ENV["CUBLAS_WORKSPACE_CONFIG"]:
        raise SystemExit("the child needs CUBLAS_WORKSPACE_CONFIG=:4096:8 in its environment")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mesh_train_child():
    """Phase 12's child: ``train_one_card_mesh`` with deterministic
    algorithms; its result is printed last."""
    _deterministic_child()
    print(MESH_TRAIN_RESULT + json.dumps(train_one_card_mesh(card_name())), flush=True)


def _states_equal(a_model, a_state, b_model, b_state) -> bool:
    """Every parameter and moment of two states equal bit for bit (each
    rank's local shards of a DTensor)."""
    import torch

    from repro_torch.launch import mesh as meshlib

    bp = dict(b_model.named_parameters())
    same = all(torch.equal(meshlib.local(p.detach()), meshlib.local(bp[n].detach()))
               for n, p in a_model.named_parameters())
    for k in ("m", "v"):
        same = same and all(torch.equal(meshlib.local(x), meshlib.local(b_state[k][n])) for n, x in a_state[k].items())
    return same and int(a_state["step"]) == int(b_state["step"])


def train_one_card_mesh(card: str) -> dict:
    """Phase 12: full-width smollm-360m trained over a ("data", "pool",
    "model") mesh of this one card (a 1-rank NCCL group), its parameters
    and moments placed at ``pooled_specs`` (``place_params``): 3 AdamW
    steps at phase 9's 8 x 1,024 tokens bit-equal to the same steps
    without a mesh (metrics, every parameter and moment), B5 launched
    ``train_kernel_launches`` times a step; then a ``Trainer`` on the mesh
    saves, and ``elastic_restore`` puts the state onto the card with no
    mesh, bit-equal. Then the families the reference does not pool
    (``MESH_TRAIN_FAMILIES``: qwen2-vl-7b, zamba2-1.2b, whisper-base at
    full width, depth cut where it says), each 3 steps over the same mesh
    bit-equal to its steps without one, B5/B7 launched as
    ``train_kernel_launches`` gives."""
    import tempfile

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import pooling
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model, make_train_step, train_kernel_launches, trainable
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.elastic import elastic_restore

    build.build_all()
    cfg = get_config("smollm-360m")
    api = get_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, clip_norm=1.0)
    batch = train_batch(cfg, MESH_TRAIN_ROWS, MESH_TRAIN_SEQ, seed=0, device="cuda")
    t0 = time.perf_counter()
    plain = draw_on_card(api)
    pstate = adamw_init(trainable(plain))
    step = make_train_step(api, opt)
    want = []
    for _ in range(MESH_TRAIN_STEPS):
        plain, pstate, m = step(plain, pstate, batch)
        want.append({k: float(v) for k, v in m.items()})
    plain_s = time.perf_counter() - t0
    out = {"card": card, "plain_s": plain_s}
    with tempfile.TemporaryDirectory() as tmp:
        meshlib.init_process_group(rank=0, world_size=1, store=f"{tmp}/store", backend="nccl")
        try:
            mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=MESH_TRAIN_AXES)
            specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
            src = draw_on_card(api)
            model = meshlib.place_params(src, mesh, specs)
            del src
            state = adamw_init(trainable(model))
            mstep = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs)
            got, step_ms = [], []
            zero_launch_counts()
            for _ in range(MESH_TRAIN_STEPS):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                model, state, m = mstep(model, state, batch)
                e.record()
                torch.cuda.synchronize()
                got.append({k: float(v) for k, v in m.items()})
                step_ms.append(s.elapsed_time(e))
            launches = launch_counts()["flash_attention"]
            per_step = train_kernel_launches(cfg, cfg.grad_accum)["flash_attention"]
            assert launches == per_step * MESH_TRAIN_STEPS, (launches, per_step)
            assert got == want, (got, want)
            assert _states_equal(model, state, plain, pstate), "the 1-card mesh's state departed from the plain one"
            assert got[-1]["loss"] < got[0]["loss"], got
            tr = Trainer(api, opt, TrainerConfig(ckpt_dir=f"{tmp}/ckpt"), compute_specs=api.param_specs(),
                         device="cuda")
            tr.params, tr.opt_state, tr.step = model, state, MESH_TRAIN_STEPS
            t1 = time.perf_counter()
            tr.save(sync=True)
            save_s = time.perf_counter() - t1
            template = draw_on_card(api, seed=1)  # other values: the restore must write them all
            t1 = time.perf_counter()
            (rmodel, rstate), extras = elastic_restore(CheckpointManager(f"{tmp}/ckpt"),
                                                       (template, adamw_init(trainable(template))))
            restore_s = time.perf_counter() - t1
            assert extras == {"step": MESH_TRAIN_STEPS} and not meshlib.is_dtensor(rmodel.embed)
            assert _states_equal(rmodel, rstate, model, state), "the restore without a mesh departed"
            del plain, pstate, model, state, rmodel, rstate, template, tr
            out["families"] = {arch: _one_card_mesh_family(card, arch, layers, rows, seq, mesh,
                                                           AdamWConfig(lr=lr, clip_norm=1.0))
                               for arch, layers, rows, seq, lr in MESH_TRAIN_FAMILIES}
        finally:
            torch.distributed.destroy_process_group()
    out.update({"metrics": got, "step_ms": step_ms, "flash_launches": launches,
                "flash_launches_per_step": per_step, "save_s": save_s, "restore_s": restore_s,
                "bit_equal": True})
    log(f"phase 12: smollm-360m over a 1-card (1, 1, 1) mesh, {MESH_TRAIN_ROWS} x {MESH_TRAIN_SEQ} tokens, "
        f"{MESH_TRAIN_STEPS} steps bit-equal to the plain steps (metrics, parameters, moments); loss "
        f"{got[0]['loss']:.4f} -> {got[-1]['loss']:.4f}; step ms {', '.join(f'{x:.1f}' for x in step_ms)}; "
        f"B5 {launches} = {per_step} a step; Trainer save {save_s:.2f} s, elastic restore without a mesh "
        f"{restore_s:.2f} s, bit-equal; on {card}")
    return out


def _one_card_mesh_family(card: str, arch: str, layers, rows: int, seq: int, mesh, opt) -> dict:
    """One model of ``MESH_TRAIN_FAMILIES`` (phase 12): ``MESH_TRAIN_STEPS``
    steps without a mesh, then over ``mesh`` from the same draw at the
    pooled specs, bit-equal (metrics, every parameter and moment), its
    kernels launched as ``train_kernel_launches`` gives a step."""
    import gc as gc_

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model, make_train_step, train_kernel_launches, trainable
    from repro_torch.optim import adamw_init

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    api = get_model(cfg)
    batch = train_batch(cfg, rows, seq, seed=0, device="cuda")
    plain = draw_on_card(api)
    pstate = adamw_init(trainable(plain))
    step = make_train_step(api, opt)
    want = []
    for _ in range(MESH_TRAIN_STEPS):
        plain, pstate, m = step(plain, pstate, batch)
        want.append({k: float(v) for k, v in m.items()})
    specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
    src = draw_on_card(api)
    model = meshlib.place_params(src, mesh, specs)
    del src
    state = adamw_init(trainable(model))
    mstep = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs)
    per_step = {k: v for k, v in train_kernel_launches(cfg, cfg.grad_accum).items() if v}
    got, step_ms, launched = [], [], []
    for _ in range(MESH_TRAIN_STEPS):
        zero_launch_counts()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        model, state, m = mstep(model, state, batch)
        e.record()
        torch.cuda.synchronize()
        got.append({k: float(v) for k, v in m.items()})
        step_ms.append(s.elapsed_time(e))
        counts = launch_counts()
        launched.append({k: counts[k] for k in per_step})
    assert all(x == per_step for x in launched), (arch, launched, per_step)
    assert got == want, (arch, got, want)
    assert _states_equal(model, state, plain, pstate), f"{arch}: the 1-card mesh's state departed from the plain one"
    assert got[-1]["loss"] < got[0]["loss"], (arch, got)
    log(f"phase 12: {arch} ({cfg.n_layers} of {full.n_layers} layers, grad_accum {cfg.grad_accum}) over the "
        f"1-card mesh, {rows} x {seq} tokens, {MESH_TRAIN_STEPS} steps bit-equal to the plain steps; loss "
        f"{got[0]['loss']:.4f} -> {got[-1]['loss']:.4f}; step ms {', '.join(f'{x:.1f}' for x in step_ms)}; "
        f"launches a step {per_step}; on {card}")
    del plain, pstate, model, state
    gc_.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "rows": rows, "seq": seq, "grad_accum": cfg.grad_accum, "metrics": got,
            "step_ms": step_ms, "launches_a_step": per_step, "bit_equal": True}


def _expected_bytes(api, mesh, specs) -> tuple:
    """(bytes of this rank's local parameters that the specs give, the
    leaves that no axis divides, as reference paths with their bytes a
    card)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.optim.adamw import LAYER_STACK

    total, whole = 0, {}
    for name, p in api.abstract_params().named_parameters():
        place = meshlib.placements(mesh, meshlib.leaf_spec(specs, name), p.shape)
        local = [n for n in p.shape]
        for i, q in enumerate(place):
            if q.is_shard():
                local[q.dim] //= int(mesh.size(i))
        nbytes = int(np.prod(local)) * p.element_size()
        total += nbytes
        if int(np.prod(local)) == p.numel():  # no axis of this mesh divides it: whole on every card
            path = LAYER_STACK.sub(r"\1.*.", name)
            whole[path] = whole.get(path, 0) + nbytes
    return total, whole


def _train_on_mesh(api, cfg, mesh, batch, lr: float, device: str, plant: str | None = None,
                   steps: int = MESH_TRAIN_STEPS) -> dict:
    """One model of ``train_mesh_phase`` on one rank of ``mesh``: the whole
    f32 tree drawn on the card, placed at ``pooled_specs`` and freed before
    any AdamW state exists, then ``steps`` steps (each rank's launches held
    to ``train_kernel_launches``), bytes a card against the specs, and,
    after more than one step, peak memory and one more step profiled for
    the collectives' share of device busy. ``plant``: that leaf rolled by
    one row in the shard of the mesh's pool rank 1 before the steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import make_train_step, train_kernel_launches, trainable
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = device == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
    t0 = time.perf_counter()
    full = draw_on_card(api) if cuda else api.init(0, device="cpu")
    model = meshlib.place_params(full, mesh, specs)
    del full
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the peak of training, not of the draw
    place_s = time.perf_counter() - t0
    if plant is not None:
        pool = mesh.mesh_dim_names.index("pool")
        if mesh.get_local_rank(pool) == 1:
            w = model.get_parameter(plant).to_local()
            with torch.no_grad():
                w.copy_(torch.roll(w.clone(), 1, 0))
    state = adamw_init(trainable(model))
    local = lambda t: meshlib.local(t).numel() * t.element_size()
    got_bytes = {"params": sum(local(p) for p in model.parameters()),
                 "m": sum(local(x) for x in state["m"].values()), "v": sum(local(x) for x in state["v"].values())}
    want_bytes, whole = _expected_bytes(api, mesh, specs)
    assert got_bytes == {"params": want_bytes, "m": want_bytes, "v": want_bytes}, (got_bytes, want_bytes)
    step = make_train_step(api, AdamWConfig(lr=lr, clip_norm=1.0), compute_specs=api.param_specs(),
                           storage_specs=specs)
    want = {k: v for k, v in train_kernel_launches(cfg, cfg.grad_accum).items() if v}
    metrics, step_ms, launched = [], [], []
    for _ in range(steps):
        zero_launch_counts()
        t1 = time.perf_counter()
        model, state, m = step(model, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})  # the step's end: its metrics read
        step_ms.append((time.perf_counter() - t1) * 1e3)
        counts = launch_counts()
        launched.append({k: counts[k] for k in want})
        assert launched[-1] == want or not cuda, (launched[-1], want)  # the CPU runs the plain versions
    out = {"metrics": metrics, "step_ms": step_ms, "launches": launched, "place_s": place_s,
           "bytes": got_bytes, "whole_leaves": whole, "n_params": sum(p.numel() for p in model.parameters())}
    if steps == 1 or not cuda:
        return out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the host's ops untraced: they are many
        model, state, m = step(model, state, batch)
        float(m["loss"])
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    avgs = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in avgs) / 1e3
    comm = sum(dev_us(e) for e in avgs if "nccl" in e.key.lower()) / 1e3
    out.update(peak_gib=torch.cuda.max_memory_allocated() / GIB, busy_ms=busy, nccl_ms=comm)
    del model, state
    return out


def _train_plain_step(api, batch, lr: float, device: str) -> dict:
    """One step of ``api``'s model with no mesh on this rank's card, from
    the draw ``_train_on_mesh`` places (the same seed): its metrics, and
    the card's peak."""
    import torch

    from repro_torch.models.api import make_train_step, trainable
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = device == "cuda"
    model = draw_on_card(api) if cuda else api.init(0, device="cpu")
    state = adamw_init(trainable(model))
    _, _, m = make_train_step(api, AdamWConfig(lr=lr, clip_norm=1.0))(model, state, batch)
    out = {"metrics": [{k: float(v) for k, v in m.items()}]}
    del model, state
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_walk_child():
    """``TRAIN_WALK``'s step walked on meta (``launch.dryrun.walk_cell``)
    over a fake process group of its mesh's ranks, in this process alone:
    the walk's peak a card, B5 calls and collectives, printed last."""
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model

    arch, layers, rows, seq, shape = TRAIN_WALK
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    t0 = time.perf_counter()
    with meshlib.fake_process_group(int(np.prod(shape))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=MESH_TRAIN_AXES)
        _, cost, arg_bytes, *_ = dryrun.walk_cell(get_model(cfg), ShapeSpec("walk", seq, rows, "train"), mesh,
                                                 pool=shape[MESH_TRAIN_AXES.index("pool")])
    print(TRAIN_WALK_RESULT + json.dumps({
        "peak_bytes": cost.peak_bytes, "argument_bytes": arg_bytes, "kernel_calls": dict(cost.kernel_calls),
        "collective_bytes": dict(cost.collective_bytes), "collective_ops": dict(cost.collective_ops),
        "by_group": cost.collectives, "walk_s": time.perf_counter() - t0}), flush=True)


def _restore_run(device: str, ckpt: str) -> dict:
    """(d): ``RESTORE_RUN``'s model trained 2 steps on its first mesh, saved
    (one rank writes), restored onto its second mesh with
    ``elastic_restore``: the restored state whole equal to the saved one,
    and the next step from it bit-equal to the step from the saved state
    placed directly (deterministic algorithms on for this run)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model, make_train_step, trainable
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.elastic import elastic_restore

    arch, rows, seq, first, second = RESTORE_RUN
    cuda = device == "cuda"
    cfg = get_config(arch) if cuda else get_config(arch).reduced()
    api = get_model(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, clip_norm=1.0)
    batch = train_batch(cfg, rows, seq, seed=0, device=device)
    draw = (lambda seed: draw_on_card(api, seed)) if cuda else (lambda seed: api.init(seed, device="cpu"))
    if cuda:
        torch.use_deterministic_algorithms(True)
    try:
        mesh = init_device_mesh(device, first, mesh_dim_names=MESH_TRAIN_AXES)
        specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
        model = meshlib.place_params(draw(0), mesh, specs)
        state = adamw_init(trainable(model))
        step = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs)
        for _ in range(2):
            model, state, _ = step(model, state, batch)
        t0 = time.perf_counter()
        CheckpointManager(ckpt).save(2, (model, state), {"step": 2})
        save_s = time.perf_counter() - t0
        saved = {"params": {n: meshlib.whole(p.detach()) for n, p in model.named_parameters()},
                 **{k: {n: meshlib.whole(x) for n, x in state[k].items()} for k in ("m", "v")}}
        del model, state
        onto = init_device_mesh(device, second, mesh_dim_names=MESH_TRAIN_AXES)
        specs2 = pooling.pooled_specs(api.param_specs(), api.abstract_params(), onto)
        template = draw(1)
        t0 = time.perf_counter()
        (rmodel, rstate), extras = elastic_restore(CheckpointManager(ckpt), (template, adamw_init(trainable(template))),
                                                   onto, (specs2, {"m": specs2, "v": specs2, "step": ()}))
        restore_s = time.perf_counter() - t0
        restored_equal = all(torch.equal(meshlib.whole(p.detach()), saved["params"][n])
                             for n, p in rmodel.named_parameters()) and all(
            torch.equal(meshlib.whole(x), saved[k][n]) for k in ("m", "v") for n, x in rstate[k].items())
        direct_t = draw(2)
        with torch.no_grad():
            for n, p in direct_t.named_parameters():
                p.copy_(saved["params"][n])
        direct = meshlib.place_params(direct_t, onto, specs2)
        dstate = {k: {n: meshlib.distribute(saved[k][n], onto, meshlib.leaf_spec(specs2, n)) for n in saved[k]}
                  for k in ("m", "v")}
        dstate["step"] = rstate["step"].clone()
        step2 = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs2)
        _, _, m_restored = step2(rmodel, rstate, batch)
        _, _, m_direct = step2(direct, dstate, batch)
        m_restored = {k: float(v) for k, v in m_restored.items()}
        m_direct = {k: float(v) for k, v in m_direct.items()}
        next_equal = m_restored == m_direct and _states_equal(rmodel, rstate, direct, dstate)
    finally:
        if cuda:
            torch.use_deterministic_algorithms(False)
    assert extras == {"step": 2} and restored_equal and next_equal, (extras, restored_equal, next_equal)
    return {"save_s": save_s, "restore_s": restore_s, "restored_equal": restored_equal,
            "next_equal": next_equal, "next_metrics": m_restored}


def _train_mesh_rank(rank: int, world: int, store: str, device: str, ckpt: str, out):
    """One rank of ``train_mesh_phase`` (NCCL on the cards, gloo on the CPU
    at reduced size, the rehearsal): every run of ``TRAIN_MESH_RUNS`` over
    each of its meshes, the planted fault on qwen1.5-110b's (1, 4, 1), then
    (d)."""
    import traceback

    try:
        import torch

        sys.path.insert(0, str(SRC))
        torch.set_num_threads(8 if device == "cuda" else 1)
        torch.backends.cuda.matmul.allow_tf32 = False
        import logging

        logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.launch import mesh as meshlib
        from repro_torch.models.api import get_model

        cuda = device == "cuda"
        meshlib.init_process_group(rank=rank, world_size=world, store=store, backend="nccl" if cuda else "gloo")
        if cuda:
            build.build_all()
        res = {}
        for arch, layers, rows, seq, shapes, lr in TRAIN_MESH_RUNS:
            full = get_config(arch)
            cfg = dataclasses.replace(full, n_layers=layers or full.n_layers) if cuda else full.reduced()
            api = get_model(cfg)
            f32 = get_model(dataclasses.replace(cfg, compute_dtype="float32")) if arch in TRAIN_MESH_F32 else None
            batch = train_batch(cfg, rows, seq, seed=0, device=device)
            if arch in TRAIN_MESH_PLAIN and rank == 0:
                res[f"{arch} plain"] = _train_plain_step(api, batch, lr, device)
                if f32 is not None:
                    res[f"{arch} plain f32"] = _train_plain_step(f32, batch, lr, device)
            torch.distributed.barrier()
            for shape in shapes:
                mesh = init_device_mesh(device, shape, mesh_dim_names=MESH_TRAIN_AXES)
                t0 = time.perf_counter()
                r = res[f"{arch} {shape}"] = _train_on_mesh(api, cfg, mesh, batch, lr, device)
                r.update(wall_s=time.perf_counter() - t0, tokens=rows * seq, grad_accum=cfg.grad_accum,
                         sp=cfg.sp_activations, layers=cfg.n_layers, lr=lr)
                log(f"train mesh rank {rank}: {arch} {shape}: loss "
                    f"{', '.join(f'{m['loss']:.4f}' for m in r['metrics'])}, step ms "
                    f"{', '.join(f'{x:.0f}' for x in r['step_ms'])}, {time.perf_counter() - t0:.1f} s")
                torch.distributed.barrier()
                if f32 is not None:
                    res[f"{arch} {shape} f32"] = _train_on_mesh(f32, f32.cfg, mesh, batch, lr, device, steps=1)
                    torch.distributed.barrier()
            if arch in TRAIN_MESH_PLANT:
                mesh = init_device_mesh(device, shapes[0], mesh_dim_names=MESH_TRAIN_AXES)
                res[f"{arch} planted"] = _train_on_mesh(api, cfg, mesh, batch, lr, device,
                                                        plant=TRAIN_MESH_PLANT[arch], steps=1)
                torch.distributed.barrier()
        if RESTORE_RUN is not None:
            res["restore"] = _restore_run(device, ckpt)
        torch.distributed.barrier()
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent raises it
        out.put((rank, {"error": traceback.format_exc()}))


def train_mesh_phase(card: str, world: int = 4, device: str = "cuda") -> dict:
    """Training across cards (weight pooling, ZeRO storage over ``pool``),
    one NCCL rank a card at a file store, alone on a machine with four
    cards (not part of the smoke): (a) qwen1.5-110b at full width, 4 of 80
    layers, its own config (``sp_activations``: B5 at each rank's first
    query row), 4 x 2,048 tokens over (1, 4, 1), (1, 1, 4) and (1, 2, 2);
    (b) rwkv6-7b, all 32 layers, 16 x 1,024 (``grad_accum`` 8) over (1, 2,
    2); (c) qwen2-moe-a2.7b, 12 of 24 layers, 8 x 1,024 (``grad_accum`` 4)
    over (1, 2, 2); each 3 steps on one batch (AdamW's lr by model,
    ``TRAIN_MESH_RUNS``). (d) smollm-360m 2 steps on
    (1, 2, 2), saved and restored onto (1, 4, 1): the state and the next
    step bit-equal. Checks: the loss after step 3 below step 1's and the
    metrics the same on every rank; bytes a card as the specs reckon them;
    the peak a card below 80 GiB; B5/B6 launches equal
    ``train_kernel_launches`` on each rank; the three qwen meshes' first
    step within ``MESH_AGREE``, and a planted fault beyond it. Reports step
    time, tokens/s, the NCCL kernels' share of device busy. ``device``
    "cpu" rehearses the same code at reduced size over ``gloo`` ranks."""
    import multiprocessing
    import tempfile

    os.environ.update(TRAINER_ENV)  # the ranks inherit it before CUDA starts ((d) runs deterministic)
    walk = None
    if TRAIN_WALK is not None and device == "cuda":  # on the host's cores, beside the ranks
        walk = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), TRAIN_WALK_CHILD], cwd=ROOT,
                                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=subprocess.PIPE, text=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = multiprocessing.get_context("spawn")
            out = ctx.Queue()
            procs = [ctx.Process(target=_train_mesh_rank,
                                 args=(r, world, f"{tmp}/store", device, f"{tmp}/ckpt", out)) for r in range(world)]
            for p in procs:
                p.start()
            got = dict(out.get(timeout=2400) for _ in range(world))
            for p in procs:
                p.join(timeout=60)
        walk_lines = walk.communicate(timeout=600)[0].splitlines() if walk is not None else []
    finally:
        if walk is not None and walk.poll() is None:
            walk.kill()
    errors = [r["error"] for r in got.values() if "error" in r]
    assert not errors, errors[0]
    summary = _train_mesh_summary(card, got, world, device)
    if walk is not None:
        assert walk.returncode == 0, walk_lines[-20:]
        walked = json.loads(next(x for x in walk_lines if x.startswith(TRAIN_WALK_RESULT))[len(TRAIN_WALK_RESULT):])
        summary["walk"] = _walk_vs_mesh_run(walked, got, world)
        if not summary["walk"]["within"]:
            summary["missed"].append(("walk", summary["walk"]))
    assert not summary["missed"], summary["missed"]
    return summary


def _walk_vs_mesh_run(walked: dict, got: dict, world: int) -> dict:
    """The walk of ``TRAIN_WALK`` against its measured run: the walk's peak
    a card within ``PEAK_RATIO`` of the run's peak on every card, its B5
    calls the run's launches a step on a rank, its collective bytes by kind
    beside the run's NCCL time (the walk's figures are the walk's, not
    measured)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import train_kernel_launches

    arch, layers, rows, seq, shape = TRAIN_WALK
    key = f"{arch} {shape}"
    runs = [got[r][key] for r in range(world)]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    b5 = train_kernel_launches(cfg, cfg.grad_accum)["flash_attention"]
    ratios = [walked["peak_bytes"] / (r["peak_gib"] * GIB) for r in runs]
    out = {"walk_peak_gib": walked["peak_bytes"] / GIB, "measured_peak_gib": [r["peak_gib"] for r in runs],
           "ratios": ratios, "band": PEAK_RATIO, "walk_b5": walked["kernel_calls"].get("flash_attention", 0),
           "b5_a_step": b5, "measured_b5": [r["launches"][0]["flash_attention"] for r in runs],
           "walk_collective_bytes": walked["collective_bytes"], "walk_collective_ops": walked["collective_ops"],
           "walk_by_group": walked["by_group"], "measured_nccl_ms": [r["nccl_ms"] for r in runs],
           "measured_busy_ms": [r["busy_ms"] for r in runs], "walk_s": walked["walk_s"]}
    out["within"] = all(PEAK_RATIO[0] <= x <= PEAK_RATIO[1] for x in ratios) and \
        out["walk_b5"] == b5 == out["measured_b5"][0]
    log("train mesh walk: " + json.dumps(out))
    return out


def _train_mesh_summary(card: str, got: dict, world: int, device: str) -> dict:
    """The runs' rows, then each model's first-step agreement: its bf16
    runs (its meshes and the step with no mesh) within its ``MESH_AGREE``
    and its planted fault beyond it against every one of them, and its f32
    witness runs within ``F32_AGREE``; every miss is logged, then listed."""
    summary = {"card": card}
    first = {}
    side = (" plain", " plain f32")  # rank 0's steps with no mesh
    plain = {k[:-len(e)] + e.replace(" plain", ""): got[0][k]["metrics"][0] for k in got[0] for e in side
             if k.endswith(e)}
    for key in [k for k in got[0] if k != "restore" and not k.endswith(side)]:
        runs = [got[r][key] for r in range(world)]
        r0 = runs[0]
        assert all(r["metrics"] == r0["metrics"] for r in runs), f"{key}: the ranks' metrics differ"
        row = {"metrics": r0["metrics"], "bytes_a_card": r0["bytes"], "whole_leaves": r0["whole_leaves"],
               "launches_a_step": r0["launches"][0], "place_s": r0["place_s"]}
        first[key] = r0["metrics"][0]
        if not key.endswith(("planted", " f32")):
            assert r0["metrics"][-1]["loss"] < r0["metrics"][0]["loss"], (key, r0["metrics"])
            ms = float(np.median([x for r in runs for x in r["step_ms"]]))
            row.update(step_ms=ms, step_ms_all=[r["step_ms"] for r in runs], tokens_per_s=r0["tokens"] / ms * 1e3,
                       wall_s=r0["wall_s"], state_bytes=16 * r0["n_params"], n_params=r0["n_params"],
                       grad_accum=r0["grad_accum"], sp=r0["sp"], layers=r0["layers"], lr=r0["lr"])
            if device == "cuda":
                peaks = [r["peak_gib"] for r in runs]
                assert max(peaks) < 80, (key, peaks)
                row.update(peak_gib=peaks, busy_ms=[r["busy_ms"] for r in runs],
                           nccl_share=[r["nccl_ms"] / r["busy_ms"] for r in runs])
        summary[key] = row
        log(f"train mesh {key}: " + json.dumps(row))
    rel = lambda a, b, k: abs(a[k] - b[k]) / abs(b[k])
    pairs = lambda vs, bound: {k: max((rel(a, b, k) for a in vs for b in vs), default=0.0) for k in bound}
    missed = []  # every agreement checked and logged first, then the misses raised together
    for arch, bound in MESH_AGREE.items():  # a subset of the runs may leave one out (TRAIN_MESH_RUNS set so)
        runs = {k[len(arch) + 1:]: v for k, v in first.items() if k.startswith(arch + " ")}
        bf16 = [v for k, v in runs.items() if not k.endswith(("planted", "f32"))] + \
            ([plain[arch]] if arch in plain else [])
        if len(bf16) < 2:
            continue
        f32 = [v for k, v in runs.items() if k.endswith("f32")] + \
            ([plain[arch + " f32"]] if arch + " f32" in plain else [])
        agree = pairs(bf16, bound)
        row = {"readings": agree, "bound": bound, "runs": len(bf16)}
        if not all(agree[k] <= bound[k] for k in bound):
            missed.append((arch, "bf16", agree))
        if "planted" in runs:
            row["planted"] = {k: min(rel(runs["planted"], b, k) for b in bf16) for k in bound}
            if not any(row["planted"][k] > bound[k] for k in bound):
                missed.append((arch, "planted", row["planted"]))
        if len(f32) >= 2:
            row.update(f32_readings=pairs(f32, F32_AGREE), f32_bound=F32_AGREE)
            if not all(row["f32_readings"][k] <= F32_AGREE[k] for k in F32_AGREE):
                missed.append((arch, "f32", row["f32_readings"]))
        summary[f"{arch}_first_step_agreement"] = row
        log(f"train mesh: {arch}'s first steps: " + json.dumps(row))
    if "restore" in got[0]:
        summary["restore"] = got[0]["restore"]
        log("train mesh (d) restore: " + json.dumps(got[0]["restore"]))
    summary["missed"] = missed
    return summary


# the lr witness: rwkv6-7b's rise at lr 1e-4 (run AM4, 32 layers over four
# cards) looked for on one card, at train_mesh_phase's batch:
# (arch, layers one card holds with AdamW's state, rows, sequence, lr, steps)
LR_WITNESS = ("rwkv6-7b", 8, 16, 1024, 1e-4, 2)


def lr_witness(card: str, device: str = "cuda") -> dict:
    """``LR_WITNESS``'s model trained on one card without a mesh and over a
    (1, 1, 1) mesh at the pooled specs, each from the same draw, at the lr
    its 32 layers rose at across four cards: each step's metrics, whether
    the two runs' metrics are equal, and the largest difference of each
    parameter or moment that is not bit-equal. Not part of
    the smoke: run it alone in a process set up as phase 12's child
    (``TRAINER_ENV`` in the environment, then ``_deterministic_child()``);
    ``device`` "cpu" rehearses it at reduced size."""
    import tempfile

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import get_model, make_train_step, trainable
    from repro_torch.optim import AdamWConfig, adamw_init

    arch, layers, rows, seq, lr, steps = LR_WITNESS
    cuda = device == "cuda"
    cfg = dataclasses.replace(get_config(arch), n_layers=layers) if cuda else get_config(arch).reduced()
    api = get_model(cfg)
    opt = AdamWConfig(lr=lr, clip_norm=1.0)
    batch = train_batch(cfg, rows, seq, seed=0, device=device)
    draw = (lambda: draw_on_card(api)) if cuda else (lambda: api.init(0, device="cpu"))

    def run(model, step):
        state, metrics, step_ms = adamw_init(trainable(model)), [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            step_ms.append((time.perf_counter() - t0) * 1e3)
        host = {n: meshlib.local(p.detach()).cpu() for n, p in model.named_parameters()}
        host.update({f"{k}.{n}": meshlib.local(x).cpu() for k in ("m", "v") for n, x in state[k].items()})
        return metrics, step_ms, host

    plain, plain_ms, plain_state = run(draw(), make_train_step(api, opt))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        meshlib.init_process_group(rank=0, world_size=1, store=f"{tmp}/store", backend="nccl" if cuda else "gloo")
        try:
            mesh = init_device_mesh(device, (1, 1, 1), mesh_dim_names=MESH_TRAIN_AXES)
            specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
            step = make_train_step(api, opt, compute_specs=api.param_specs(), storage_specs=specs)
            meshed, mesh_ms, mesh_state = run(meshlib.place_params(draw(), mesh, specs), step)
        finally:
            torch.distributed.destroy_process_group()
    differ = {n: float((x.float() - mesh_state[n].float()).abs().max()) for n, x in plain_state.items()
              if not torch.equal(x, mesh_state[n])}
    out = {"card": card, "arch": arch, "layers": cfg.n_layers, "tokens": rows * seq, "lr": lr,
           "grad_accum": cfg.grad_accum, "plain": plain, "plain_ms": plain_ms, "mesh": meshed, "mesh_ms": mesh_ms,
           "metrics_equal": plain == meshed, "leaves_differing": differ}
    log("lr witness: " + json.dumps({**out, "leaves_differing": len(differ),
                                     "largest_difference": max(differ.values(), default=0.0)}))
    return out


def whisper_flash_sites(attention: dict, wp: dict, keep: tuple) -> dict:
    """whisper-base's B5 entries in the kernels line: its decoder's causal
    prompt and ``check_attention``'s other sites, each with the launches
    counted at its site on phase 3g's path (``serve``'s ``flash_sites``:
    the prompt is the decoder's self-attention at prefill, and the
    cross-attention's decode launches are its decode graph's), and the
    launches of every site together, which they must add up to."""
    counted = wp["flash_sites"]
    by_site = {site: counted[where].get(fn, 0) for site, (where, fn) in (
        ("prompt", ("prefill", "self")), ("encoder", ("prefill", "encoder")),
        ("cross_prefill", ("prefill", "cross")), ("cross_decode", ("decode_graph", "cross")))}
    every_site = wp["launches"]["flash_attention"]
    assert sum(by_site.values()) == every_site, (by_site, every_site)
    return {"launches": by_site["prompt"], "launches_every_site": every_site,
            **{site: {**{k: r[k] for k in keep if k in r}, "launches": by_site[site]}
               for site, r in attention["flash_attention"]["whisper-base"]["sites"].items()}}


def main():
    import torch

    if sys.argv[1:] == [TRAIN_WALK_CHILD] and (SRC / "repro_torch").is_dir():  # a walk on meta: no card
        return train_walk_child()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: the port's package is not at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    if sys.argv[1:] == [TRAINER_CHILD]:
        return trainer_child()
    if sys.argv[1:] == [MESH_TRAIN_CHILD]:
        return mesh_train_child()
    t_start = time.perf_counter()

    # phase 1: device and build
    card = card_name()
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
    train_attention = check_train_attention()
    sp_attention = check_sp_attention()
    kernels.update(check_scans())
    train_scans = check_train_scans()
    t2 = time.perf_counter()
    log(f"phase 2 {t2 - t_start:.1f} s")
    # phase 3: the main path (whole-slot, decode graphs), smollm-360m; 3b:
    # qwen2.5-3b; 3c: rwkv6-7b; 3d: zamba2-1.2b; 3e: granite-moe-3b (with
    # its moe checks); 3f: qwen2-vl-7b (with its M-RoPE checks); 3g:
    # whisper-base; each followed (3x) by the chunked path on the same
    # params and requests, or for vlm and audio the same chunk budget,
    # which they prefill whole under
    from repro_torch.runtime.serving import CHUNKABLE_FAMILIES

    paths, chunked, moe_res, vlm_res, kept = {}, {}, {}, {}, {}
    for arch, n_req, widths, ssm in (
        ("smollm-360m", 16, (32, 960, 15, 5, 2560, 49152), None),
        ("qwen2.5-3b", 6, (36, 2048, 16, 2, 11008, 151936), None),
        ("rwkv6-7b", 6, (32, 4096, 64, 64, 14336, 65536), (64, 0, 0)),
        ("zamba2-1.2b", 8, (38, 2048, 32, 32, 8192, 32000), (64, 64, 6)),
        ("granite-moe-3b-a800m", 6, (32, 1536, 24, 8, 512, 49155), None),
        ("qwen2-vl-7b", 6, (28, 3584, 28, 4, 18944, 152064), None),
        ("whisper-base", 8, (6, 512, 8, 8, 2048, 51865), None),
    ):
        t3 = time.perf_counter()
        paths[arch] = serve(card, arch, n_req, widths, ssm,
                            sites=WHISPER_FLASH_SITES if arch == "whisper-base" else None)
        t3x = time.perf_counter()
        log(f"phase 3 {arch} {t3x - t3:.1f} s")
        family = paths[arch]["cfg"].family
        if family in CHUNKABLE_FAMILIES:
            chunked[arch] = serve_chunked(card, arch, paths[arch])
        else:
            chunked[arch] = serve_unchunkable(card, arch, paths[arch])
        log(f"phase 3x {arch} chunked {time.perf_counter() - t3x:.1f} s")
        if family == "moe":
            t3e = time.perf_counter()
            moe_res[arch] = moe_checks(card, paths[arch])
            log(f"phase 3e {arch} moe checks {time.perf_counter() - t3e:.1f} s")
        if family == "vlm":
            t3f = time.perf_counter()
            vlm_res[arch] = vlm_checks(card, paths[arch])
            log(f"phase 3f {arch} M-RoPE checks {time.perf_counter() - t3f:.1f} s")
        if arch in MESH_FAMILIES:  # phase 11's model of its family
            kept[arch] = cut_depth(paths[arch]["params"], paths[arch]["cfg"], MESH_FAMILIES[arch])
        if arch != "smollm-360m":
            del paths[arch]["params"], paths[arch]["api"]
            gc.collect()
            torch.cuda.empty_cache()
    mp = paths["smollm-360m"]
    log(f"phase 3 smollm-360m to whisper-base {time.perf_counter() - t2:.1f} s")
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

    # phase 8: training: reduced losses and gradients of every family on
    # the card against the CPU, then smollm-360m, zamba2-1.2b, whisper-base
    # and rwkv6-7b (4 layers) at full width taking AdamW steps (their
    # launch counts zeroed before each step, read after)
    t8 = time.perf_counter()
    train_reduced = train_reduced_card_vs_cpu()
    log(f"phase 8 reduced training card vs CPU {time.perf_counter() - t8:.1f} s")
    train = {}
    for arch in TRAIN_RUNS:
        t8f = time.perf_counter()
        train[arch] = train_full_width(card, arch)
        log(f"phase 8 training {arch} {time.perf_counter() - t8f:.1f} s")

    # phase 9: the trainer on the card (a child process with deterministic
    # algorithms): a crash, a restore and a bitwise resume, then the launcher
    t9 = time.perf_counter()
    trainer = trainer_phase()
    log(f"phase 9 trainer {time.perf_counter() - t9:.1f} s")

    # phase 10: the launch layer: the serving launcher at full width, the
    # cost walk against the card, the dry run and its report
    t10 = time.perf_counter()
    launch_layer = {"launcher": launcher_phase()}
    t10b = time.perf_counter()
    log(f"phase 10a launcher {t10b - t10:.1f} s")
    launch_layer["walk_vs_card"] = walk_vs_card(card)
    t10c = time.perf_counter()
    log(f"phase 10b walk vs card {t10c - t10b:.1f} s")
    launch_layer["dryrun"] = dryrun_phase()
    log(f"phase 10c dry run {time.perf_counter() - t10c:.1f} s")

    # phase 11: the sharded engine over a mesh of this one card, against
    # phase 7's 1-shard engine, then one model of each other family against
    # the same engine without a mesh
    t11 = time.perf_counter()
    mesh_one = serve_mesh_one(card, mp, kept)
    log(f"phase 11 mesh {time.perf_counter() - t11:.1f} s")

    # phase 12: training over a mesh of this one card (a child process with
    # deterministic algorithms), against the same steps without a mesh
    t12 = time.perf_counter()
    mesh_train = _child_phase(MESH_TRAIN_CHILD, MESH_TRAIN_RESULT, "phase 12")
    log(f"phase 12 mesh training {time.perf_counter() - t12:.1f} s")

    # phase 6: summary. Each row's launches are those of the main path that
    # runs it; the attention rows carry smollm-360m's numbers, and the other
    # models' ride along
    # chunked_launches: the same kernels' launches on that model's chunked path;
    # fleet_launches: on the fleet's path, summed over its hosts;
    # sharded_launches: B1's on phase 7's path at each shard count;
    # mesh_launches: each kernel's on phase 11's paths (a 1-card mesh), by model
    carrier = {"tiered_segmented": "smollm-360m", "paged_attention": "smollm-360m",
               "flash_attention": "smollm-360m", "wkv6": "rwkv6-7b", "ssd": "zamba2-1.2b"}
    launches = {"tiered_segmented": mp["launches"]["tiered_segmented"],
                "tiered_gather": vp["tiered_gather"], "gather_rows": vp["gather_rows"],
                "paged_attention": mp["launches"]["paged_attention"],
                "flash_attention": mp["launches"]["flash_attention"],
                "wkv6": paths["rwkv6-7b"]["launches"]["wkv6"],
                "ssd": paths["zamba2-1.2b"]["launches"]["ssd"]}
    keep = ("shapes", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "upcast_ms",
            "paged_over_pages_ms", "paged_bound_ms")
    for name in ("paged_attention", "flash_attention"):
        per = attention[name]
        kernels[name] = {**{k: v for k, v in per["smollm-360m"].items() if k != "sites"}, **{arch: {
            **{k: per[arch][k] for k in keep if k in per[arch]},
            "launches": paths[arch]["launches"][name]} for arch in MODELS_BESIDE}}
    kernels["flash_attention"]["whisper-base"].update(
        whisper_flash_sites(attention, paths["whisper-base"], keep))
    # the kernels on phase 8's training paths: phase 2's numbers at each
    # training shape (B5 with and without its lse, B6 and B7 with and
    # without their chunk states), with the launches of the full-width
    # run that makes them (summed over its steps; whisper-base's B5 by site)
    keep_train = lambda r: {k: v for k, v in r.items() if k not in ("bytes", "errs")}
    launches_of = lambda arch, name: [c.get(name, 0) for c in train[arch]["launches_per_step"]]
    smol = launches_of("smollm-360m", "flash_attention")
    kernels["flash_attention"]["training"] = {
        **keep_train(train_attention["smollm-360m self"]), "launches": sum(smol), "launches_per_step": smol,
        "launches_per_micro_batch": smol[0] // TRAIN_ACCUM}
    whisper_sites = {site: sum(c[site] for c in train["whisper-base"]["flash_by_site"])
                     for site in ("encoder", "decoder", "cross")}
    site_launches = {"whisper-base encoder": whisper_sites["encoder"],
                     "whisper-base self": whisper_sites["decoder"] - whisper_sites["cross"],
                     "whisper-base cross": whisper_sites["cross"],
                     "zamba2-1.2b shared": sum(launches_of("zamba2-1.2b", "flash_attention"))}
    assert sum(site_launches[k] for k in site_launches if k.startswith("whisper")) == \
        sum(launches_of("whisper-base", "flash_attention")), site_launches
    kernels["flash_attention"]["training_sites"] = {
        label: {**keep_train(train_attention[label]), "launches": n} for label, n in site_launches.items()}
    # B5 at sequence-parallel rows: its launches come from train_mesh_phase (four
    # cards), not from this one card's paths
    kernels["flash_attention"]["training_sp"] = {label: keep_train(r) for label, r in sp_attention.items()}
    # B5's launches on phase 9's path: every Trainer and launcher step
    kernels["flash_attention"]["trainer"] = {k: trainer[k] for k in ("launches", "launches_per_step",
                                                                     "trainer_steps")}
    for name, arch in (("wkv6", "rwkv6-7b"), ("ssd", "zamba2-1.2b")):
        kernels[name]["training"] = {**keep_train(train_scans[name]), "launches": sum(launches_of(arch, name)),
                                     "launches_per_step": launches_of(arch, name)}
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
            **({"mesh_launches": {"1": {arch: m["launches"][name] for arch, m in mesh_one.items()
                                        if name in m["launches"]}}}
               if any(name in m["launches"] for m in mesh_one.values()) else {}),
            **{k: r[k] for k in (*MODELS_BESIDE, "training", "training_sites", "trainer", "shapes") if k in r},
            **({"decode": {k: v for k, v in r["decode"].items() if k != "bytes"}} if "decode" in r else {}),
        })
    log("decode step profiles: " + "; ".join(f"{arch} {p['profile']}" for arch, p in paths.items()))
    log("moe checks: " + json.dumps(moe_res))
    log("M-RoPE checks: " + json.dumps(vlm_res))
    log("sharded engine: " + json.dumps(sharded))
    log("mesh engine (1 card): " + json.dumps(mesh_one))
    log("training: " + json.dumps({"reduced_card_vs_cpu": train_reduced, **train}))
    log("trainer: " + json.dumps(trainer))
    log("mesh training (1 card): " + json.dumps(mesh_train))
    log("launch layer: " + json.dumps(launch_layer))
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
