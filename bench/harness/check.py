"""Whether what the timed path produced is correct, against the plain
reference, once the window has closed and the program's state is freed.

The numbers; a cell compares those its limits file names
(``bench/limits/<cell>.json``), each beside its limit:

* ``logit_gap``: over a sample of the requests the window finished, drawn
  from the seed with the longest among them, the widest gap by which a
  served token's logit lies below the reference's best logit at that
  position (the reference run once over each prompt with its served
  tokens). Served tokens are greedy, so a sound run reads only the gaps of
  near ties that rounding flips.
* ``logits_err``: over the same sample, each prefill's whole row of
  logits at the prompt's last position (the row its first token is chosen
  from) against the reference's, as a relative error in the L2 norm: the
  median over the sample. The row carries every layer of the prefill: B5,
  the experts, the head. The median, because single rows swing: within one
  run a row can read twice the run's median (bfloat16 rounding flips a
  near-tied expert here and there), while the median holds from seed to
  seed.
* ``decode_err``: the same of the decode's whole row of logits at a few
  steps of the window (the requests and steps of ``kv_rows``): every layer
  of the decode, B4 among them.
* ``kv_rows``: the tier store's gathered rows (B1) of a few requests at
  a few steps of the window, against the keys and values the reference
  computes for those requests' tokens: the worst row's largest error over
  its largest entry, over the first layer's keys and values in each row
  (the row's first slice and the slice that starts its values): a wrong
  page, a stale position or a wrong dequantization.
* ``books``: the store's near and far hit books after the window against
  the harness's own count of every page id it was asked for, split by the
  tier map at the time of the ask: exact.

The control is the reference at a lower precision put in the program's
place (``judge``'s ``control``), read by the same numbers on the same
sample and the same kept rows, and judged by the same ``correct``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import spec
from bench.reference.common import Precision, no_tf32


def sample(run) -> List:
    """Finished requests, drawn from the seed: the longest first, then
    others until they hold the mix's ``sample_tokens`` served tokens and
    ``sample_requests`` requests."""
    ck = run.mix["check"]
    n_tokens, n_requests = int(ck["sample_tokens"]), int(ck.get("sample_requests", 1))
    done = sorted((r for r in run.reqs.values() if r.done_step >= 0), key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.item.decode_len, -r.rid))
    rng = np.random.default_rng([run.seed, 2])
    rest = [done[i] for i in rng.permutation(len(done)) if done[i] is not longest]
    out, total = [longest], longest.item.decode_len + 1
    for r in rest:
        if total >= n_tokens and len(out) >= n_requests:
            break
        out.append(r)
        total += r.item.decode_len + 1
    return out


def served_logits(forward, weights, cfg: dict, prompt: np.ndarray, served: np.ndarray, device,
                  prec: Precision = Precision()) -> torch.Tensor:
    """The reference's logits at every position that chose a served token
    (the prompt's last, then each served token's but the last)."""
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]), device=device)
    logits, _, _ = forward(weights, cfg, seq, prec)
    return logits[len(prompt) - 1:]


def gaps(at: torch.Tensor, tokens) -> torch.Tensor:
    """The best logit less the logit of ``tokens``, position by position."""
    tok = torch.as_tensor(tokens, device=at.device).long()
    return at.max(-1).values - at.gather(1, tok[:, None])[:, 0]


def l2_errors(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's error over the reference's row, in the L2 norm."""
    return (got.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)


def expected_rows(k: torch.Tensor, v: torch.Tensor, n_pages: int, length: int, page_size: int):
    """The payload rows of a sequence's first ``n_pages`` pages: each page's
    last written position's keys and values over every layer and head, all
    keys then all values. k, v: (layers, T, heads, dim)."""
    pos = [min((j + 1) * page_size, length) - 1 for j in range(n_pages)]
    kk = k[:, pos].transpose(0, 1).reshape(n_pages, -1)
    vv = v[:, pos].transpose(0, 1).reshape(n_pages, -1)
    return torch.cat([kk, vv], dim=1)


def first_layer(rows: torch.Tensor, layers: int) -> torch.Tensor:
    """The first layer's keys and values of payload rows of ``layers`` layers."""
    w = rows.shape[1] // (2 * layers)
    half = rows.shape[1] // 2
    return torch.cat([rows[:, :w], rows[:, half: half + w]], dim=1)


def row_error(rows: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's largest error over its largest reference entry."""
    err = (rows.float() - ref).abs().amax(dim=1) / ref.abs().amax(dim=1).clamp_min(1e-30)
    return float(err.max())


def judge(run, hist: np.ndarray, firsts: np.ndarray, books: Dict[str, int], limits: Dict[str, float],
          device, control: Optional[Precision] = None) -> dict:
    """Every number compared, with its limit (``numbers``); each sampled
    request's and each kept row's reading (``items``); the tokens judged.

    With ``control``, the reference at that precision stands in the
    program's place: at each position of the same prompts and served tokens
    its first choice is judged as the served token, its row at the prompt's
    last position as the prefill's, its rows at the kept steps as the
    decode's, and its keys and values at the kept pages as the gathered
    rows. It keeps no store, so it has no ``books``."""
    no_tf32()
    forward = spec.reference(run.cell.family, run.cell.root).forward
    cfg = run.config["port"]
    widest, first, served_n = [], [], 0
    for req in sample(run):
        served = run.served_tokens(req, hist, firsts)
        at = served_logits(forward, run.leaves, cfg, req.item.tokens, served, device)
        if control is None:
            tokens, row = served, run.first_rows[req.rid]
        else:
            low = served_logits(forward, run.leaves, cfg, req.item.tokens, served, device, control)
            tokens, row = low.argmax(-1), low[0]
        widest.append(float(gaps(at, tokens).max()))
        first.append(float(l2_errors(row, at[0])))
        served_n += len(served)
    kv_first, decode = [], []
    ps = run.ecfg.page_size
    for cap in run.captures:
        req = run.reqs[cap.rid]
        s = cap.k - req.k0
        length = req.prompt_len + s
        n_pages = -(-length // ps)
        if len(cap.ids) != n_pages:
            raise RuntimeError(f"request {cap.rid} held {len(cap.ids)} pages at length {length}")
        # the cache held the prompt and the first s served tokens; the step's
        # decode fed served token s and gave the logits that chose s + 1
        served = run.served_tokens(req, hist, firsts, upto=s)
        seq = torch.as_tensor(np.concatenate([req.item.tokens, served]), device=device)
        at, k, v = forward(run.leaves, cfg, seq)
        ref = expected_rows(k, v, n_pages, length, ps)
        rows, row = cap.rows, cap.logits
        if control is not None:
            low, k, v = forward(run.leaves, cfg, seq, control)
            rows, row = expected_rows(k, v, n_pages, length, ps), low[-1]
        layers = k.shape[0]
        kv_first.append(row_error(first_layer(rows, layers), first_layer(ref, layers)))
        decode.append(float(l2_errors(row, at[-1])))
    worst = lambda xs: max(xs) if xs else float("inf")
    median = lambda xs: float(np.median(xs)) if xs else float("inf")
    values = {"logit_gap": worst(widest), "logits_err": median(first), "decode_err": median(decode),
              "kv_rows": worst(kv_first)}
    if control is None:
        values["books"] = abs(books["near"] - run.books["near"]) + abs(books["far"] - run.books["far"])
    # a cell compares the numbers its limits file names
    out = {name: {"value": values[name], "limit": limit} for name, limit in limits.items() if name in values}
    return {"numbers": out, "served": served_n, "requests": len(widest), "rows_captured": len(kv_first),
            "items": {"logit_gap": widest, "logits_err": first, "decode_err": decode, "kv_rows": kv_first}}


def correct(numbers: Dict[str, dict]) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
