"""Time the design choices of the redesigned kernels on the card.

    PYTHONPATH=src python -m repro_torch.kernels.compare

* f32 flash attention: O += P V on TF32 wgmma over a transposed V (the
  build's own choice at head_dim 64) against mma.sync m16n8k8 reading V's
  rows (a second build of ``csrc/flash_attention.cu`` with
  ``-DFA_F32_PV_MMA_SYNC``), in the order A B B A at each shape.
* the Mamba2 SSD prefill: each split count 1, 2, 4 and 8 at zamba2-1.2b's
  widths (64 heads, P = N = 64) and a few prompt lengths, in the order
  1 2 4 8 8 4 2 1, beside the clusters of each count the card keeps
  resident at once.
* the WKV6 prefill the same way, at rwkv6-7b's widths (64 heads of 64).
* the tiered lookup (B1) at the serving step's store (512 gathers of D =
  20480 over 1024 pages, 307 near, 9 segments): the op's time, and its
  phase clocks from a ``-DTG_PHASE_CLOCKS`` build (per block, the global
  timer at its start, once its items are resolved and at its end).

Each time is ``timing.time_ms``: the median device time of one call over
``--reps`` calls, the L2 flushed before each, as ``chip_smoke.py`` times.
Each output is held to the plain version first. Prints one line a shape
and, last, one JSON object with every time. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.timing import time_ms


def variant(name: str, define: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with ``-D<define>`` beside the default build."""
    lib = build.target(name).with_name(f"lib{name}-{define}.so")
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-D{define}", "-o", str(lib),
                    str(build.CSRC / f"{name}.cu")], check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    out.repro_error_string.argtypes = [ctypes.c_int]
    out.repro_error_string.restype = ctypes.c_char_p
    return out


FLASH_SHAPES = (  # (hq, hkv, L, head_dim, causal): zamba2-1.2b's prefill first
    (32, 32, 512, 64, True),
    (4, 4, 1000, 64, True),
    (6, 2, 300, 64, False),
    (4, 4, 200, 128, True),
)


def compare_flash_pv(reps: int):
    from repro_torch.kernels.flash_attention import ops, ref

    build.build_all(["flash_attention"])
    libs = {"wgmma": build.load("flash_attention"),
            "mma_sync": variant("flash_attention", "FA_F32_PV_MMA_SYNC")}
    g = torch.Generator().manual_seed(0)
    rows = []
    for hq, hkv, L, d, causal in FLASH_SHAPES:
        q = torch.randn(1, hq, L, d, generator=g).cuda()
        k, v = (torch.randn(1, hkv, L, d, generator=g).cuda() for _ in range(2))
        plain = ref.flash_attention_ref(q, k, v, causal=causal)

        def run(which):
            build._LIBS["flash_attention"] = libs[which]
            return ops.flash_attention(q, k, v, causal=causal)

        out = {w: run(w) for w in libs}
        err = {w: float((o - plain).abs().max()) for w, o in out.items()}
        assert max(err.values()) <= 2e-5, err
        times = {w: [] for w in libs}
        for w in ("wgmma", "mma_sync", "mma_sync", "wgmma"):
            build._LIBS["flash_attention"] = libs[w]
            times[w].append(time_ms(lambda: ops.flash_attention(q, k, v, causal=causal), reps))
        build._LIBS["flash_attention"] = libs["wgmma"]
        row = {"hq": hq, "hkv": hkv, "L": L, "head_dim": d, "causal": causal, "ms": times,
               "max_abs_err": err}
        print(f"flash f32 hq {hq} hkv {hkv} L {L} d {d} causal {causal}: "
              + "; ".join(f"{w} {t[0]:.5f} / {t[1]:.5f} ms (err {err[w]:.2e})" for w, t in times.items()),
              flush=True)
        rows.append(row)
    return rows


SSD_LENGTHS = (256, 512, 1024)  # 512: zamba2-1.2b's prompt in chip_smoke.py


def compare_ssd_split(reps: int):
    from repro_torch.kernels.mamba2_scan import ops, ref

    h, p, n = 64, 64, 64
    fit = {s: ops.max_active_clusters(p, n, s) for s in (1, 2, 4, 8)}
    print(f"ssd prefill clusters resident at once, by split: {fit}", flush=True)
    g = torch.Generator().manual_seed(1)
    rows = []
    for t in SSD_LENGTHS:
        x = torch.randn(1, t, h, p, generator=g).cuda()
        dt = (torch.rand(1, t, h, generator=g) * 0.5).cuda()
        a = -torch.rand(h, generator=g).cuda() - 0.5
        bm, cm = (torch.randn(1, t, n, generator=g).cuda() / math.sqrt(n) for _ in range(2))
        d = torch.randn(h, generator=g).cuda()
        args = (x, dt, a, bm, cm, d, None)
        y_ref, s_ref = ref.ssd_ref(*args)
        splits = [s for s in (1, 2, 4, 8) if s <= -(-t // ref.CHUNK)]
        err = {}
        for s in splits:
            y, st = ops._launch(*args, None, s)
            err[s] = max(float((y - y_ref).abs().max() / y_ref.abs().max()),
                         float((st - s_ref).abs().max() / s_ref.abs().max()))
        assert max(err.values()) <= 1e-4, err
        times = {s: [] for s in splits}
        for s in splits + splits[::-1]:
            times[s].append(time_ms(lambda: ops._launch(*args, None, s), reps))
        rows.append({"b": 1, "T": t, "H": h, "P": p, "N": n, "ms": times, "rel_err": err,
                     "split_count": ref.split_count(t, 1, h)})
        print(f"ssd prefill (1, {t}, {h}, {p}), N {n}, split_count {ref.split_count(t, 1, h)}: "
              + "; ".join(f"split {s} {v[0]:.5f} / {v[1]:.5f} ms" for s, v in times.items()), flush=True)
    return {"resident_clusters": fit, "rows": rows}


WKV6_LENGTHS = (256, 512, 1024)  # 512: rwkv6-7b's prompt in chip_smoke.py


def compare_wkv6_split(reps: int):
    from repro_torch.kernels.rwkv6_scan import ops, ref

    h, hd = 64, 64
    fit = {s: ops.max_active_clusters(hd, s) for s in (1, 2, 4, 8)}
    print(f"wkv6 prefill clusters resident at once, by split: {fit}", flush=True)
    g = torch.Generator().manual_seed(2)
    rows = []
    for t in WKV6_LENGTHS:
        r, k, v = (torch.randn(1, t, h, hd, generator=g).cuda() for _ in range(3))
        lw = -torch.exp(torch.randn(1, t, h, hd, generator=g) - 1.0).cuda()
        u = torch.randn(h, hd, generator=g).cuda()
        args = (r, k, v, lw, u, None)
        y_ref, s_ref = ref.wkv6_ref(*args)
        splits = [s for s in (1, 2, 4, 8) if s <= -(-t // ref.CHUNK)]
        err = {}
        for s in splits:
            y, st = ops._launch(*args, None, s)
            err[s] = max(float((y - y_ref).abs().max() / y_ref.abs().max()),
                         float((st - s_ref).abs().max() / s_ref.abs().max()))
        assert max(err.values()) <= 1e-4, err
        times = {s: [] for s in splits}
        for s in splits + splits[::-1]:
            times[s].append(time_ms(lambda: ops._launch(*args, None, s), reps))
        rows.append({"b": 1, "T": t, "H": h, "hd": hd, "ms": times, "rel_err": err,
                     "split_count": ref.split_count(t, 1, h)})
        print(f"wkv6 prefill (1, {t}, {h}, {hd}), split_count {ref.split_count(t, 1, h)}: "
              + "; ".join(f"split {s} {v[0]:.5f} / {v[1]:.5f} ms" for s, v in times.items()), flush=True)
    return {"resident_clusters": fit, "rows": rows}


def serving_store(seed: int = 0):
    """The serving step's tiered store on the card, as ``chip_smoke.py`` and
    the card tests take it: (hot, cold_q, cold_scales, tier, slot, ids,
    seg_of, n_segments), 1024 pages of D = 20480 (2 x 32 layers x 5 KV heads
    x 64), 307 near in f32, the rest int8 with per-row scales, and 512
    gathers in 8 slot walks padded into segment 8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_pages, near_cap, d, n_seg = 1024, 307, 20480, 9
    tier = np.ones(n_pages, np.int32)
    near_pages = rng.choice(n_pages, near_cap, replace=False)
    tier[near_pages] = 0
    slot = np.arange(n_pages, dtype=np.int32)
    slot[near_pages] = rng.permutation(near_cap).astype(np.int32)
    walks = [rng.choice(n_pages, int(rng.integers(40, 60)), replace=False) for _ in range(8)]
    ids = np.concatenate(walks)
    seg = np.repeat(np.arange(8, dtype=np.int32), [w.size for w in walks])
    pad = 512 - ids.size
    ids = np.concatenate([ids, np.zeros(pad, np.int64)]).astype(np.int32)
    seg = np.concatenate([seg, np.full(pad, n_seg - 1, np.int32)])
    t = lambda a, dt: torch.as_tensor(a).to(dt).cuda()
    hot = torch.randn(near_cap, d, generator=torch.Generator().manual_seed(seed)).cuda()
    return (hot, t(rng.integers(-127, 128, (n_pages, d)), torch.int8),
            t(rng.uniform(1e-3, 1e-1, n_pages), torch.float32), t(tier, torch.int32),
            t(slot, torch.int32), t(ids, torch.int32), t(seg, torch.int32), n_seg)


def compare_tiered(reps: int):
    import numpy as np

    from repro_torch.kernels.tiered_gather import ops, ref

    build.build_all(["tiered_gather"])
    plain = build.load("tiered_gather")
    clocked = variant("tiered_gather", "TG_PHASE_CLOCKS")
    clocked.tg_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    args = serving_store()
    rows_p, hits_p = ref.tiered_lookup_segments_ref(*args)
    op_ms = time_ms(lambda: ops.tiered_lookup_segments(*args), reps)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    try:
        build._LIBS["tiered_gather"] = clocked
        rows, hits = ops.tiered_lookup_segments(*args)
        torch.cuda.synchronize()
        assert torch.equal(rows, rows_p) and torch.equal(hits, hits_p)
        flush.zero_()  # one launch as the timing finds the L2
        torch.cuda._sleep(2_000_000)
        ops.tiered_lookup_segments(*args)
        torch.cuda.synchronize()
        n = torch.cuda.get_device_properties(0).multi_processor_count * 3
        c = np.zeros(4 * n, dtype=np.uint64)
        build.check(clocked, clocked.tg_phase_clocks(c.ctypes.data, n), "tg_phase_clocks")
        c = c.reshape(n, 4).astype(np.int64)
    finally:
        build._LIBS["tiered_gather"] = plain
    t0 = c[:, 0].min()
    q = lambda a: [int(np.percentile(a, p)) for p in (0, 50, 90, 100)]
    clocks = {"blocks": n, "span_ns": int(c[:, 2].max() - t0), "start_ns": q(c[:, 0] - t0),
              "resolve_ns": q(c[:, 1] - c[:, 0]), "move_ns": q(c[:, 2] - c[:, 1]),
              "end_ns": q(c[:, 2] - t0), "items": q(c[:, 3])}
    print(f"tiered lookup op {op_ms:.5f} ms; phase clocks (ns; min, p50, p90, max over the blocks): "
          + "; ".join(f"{k} {v}" for k, v in clocks.items()), flush=True)
    return {"op_ms": op_ms, "phase_clocks": clocks}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "flash_f32_pv": compare_flash_pv(args.reps),
           "ssd_split": compare_ssd_split(args.reps), "wkv6_split": compare_wkv6_split(args.reps),
           "tiered": compare_tiered(args.reps)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
