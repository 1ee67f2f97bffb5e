"""Quickstart on the PyTorch port: build an assigned arch, train a few
steps, then serve it.

PYTHONPATH=src python examples/torch_quickstart.py [--arch qwen2.5-3b] [--device cpu]
Runs the REDUCED config of the chosen architecture end to end on
``--device`` (default: the CUDA card, at the widths its kernels take,
``models.api.card_widths``): a few AdamW steps through ``make_train_step``,
a short loss curve, then prefill + greedy decode.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.api import card_widths, get_model, make_serve_step, make_train_step, trainable
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if dev.type == "cuda":
        cfg = card_widths(cfg)
    api = get_model(cfg)
    print(f"arch={args.arch} family={cfg.family} reduced params on {dev}...")
    params = api.init(0, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"  {n/1e6:.2f}M params, vocab {cfg.vocab_size}, d_model {cfg.d_model}")

    # --- train a few steps on a synthetic batch
    opt_state = adamw_init({k: p.detach() for k, p in trainable(params).items()})
    # one micro-batch: 4 rows do not split into every config's grad_accum
    step = make_train_step(api, AdamWConfig(lr=1e-3), grad_accum=1)
    g = torch.Generator().manual_seed(1)
    B, S = 4, 32
    tokens = lambda *shape: torch.randint(0, cfg.vocab_size, shape, generator=g, dtype=torch.int32)
    normal = lambda *shape: torch.randn(shape, generator=g)
    if cfg.family == "vlm":
        batch = {
            "embeds": normal(B, S, cfg.d_model),
            "mrope_positions": torch.arange(S, dtype=torch.int32)[None, None].repeat(3, B, 1),
            "labels": tokens(B, S),
        }
    elif cfg.family == "audio":
        batch = {
            "tokens": tokens(B, S),
            "frames": normal(B, cfg.n_audio_frames, cfg.d_model),
            "labels": tokens(B, S),
        }
    else:
        toks = tokens(B, S + 1)
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    batch = {k: v.to(dev) for k, v in batch.items()}
    for i in range(args.steps):
        t0 = time.time()
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % 2 == 0:
            print(f"  step {i}: loss {float(metrics['loss']):.4f} ({time.time()-t0:.2f}s)")

    # --- serve: prefill a prompt, decode greedily (a cache of two pages of
    # 16, the page the card's decode kernel walks)
    if cfg.family in ("vlm", "audio"):
        print("serving demo uses token prompts; done for modality stubs.")
        return 0
    prompt = tokens(1, 8).to(dev)
    serve = make_serve_step(api)
    with torch.no_grad():
        logits, cache = api.prefill(params, {"tokens": prompt}, max_len=32)
        out = [int(t) for t in prompt[0]]
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        for _ in range(8):
            out.append(int(tok[0, 0]))
            tok, cache = serve(params, cache, tok)
    print(f"  prompt+decode ids: {out}")
    print("quickstart ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
