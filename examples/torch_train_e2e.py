"""End-to-end training driver on the PyTorch port: data pipeline -> trainer
-> checkpoint -> crash -> auto-resume -> verify the trajectory continued
exactly.

Default is a ~2M-param llama-family model for 200 steps on ``--device``
(default: the CUDA card, at the widths its attention kernel takes,
``models.api.card_widths``). For the full-scale run of this example on
the card:
  python -m repro_torch.launch.train --arch smollm-360m --steps 300 ...

PYTHONPATH=src python examples/torch_train_e2e.py [--steps 200] [--d-model 128] [--device cpu]
"""
import argparse
import dataclasses
import shutil
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models.api import card_widths, get_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig


def build(d_model, n_layers, vocab):
    cfg = get_config("smollm-360m").reduced()
    heads = max(4, d_model // 32)
    return dataclasses.replace(
        cfg, d_model=d_model, n_layers=n_layers, n_heads=heads, n_kv_heads=heads,
        d_ff=4 * d_model, vocab_size=vocab,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build(args.d_model, args.n_layers, args.vocab)
    if dev.type == "cuda":
        cfg = card_widths(cfg)
    api = get_model(cfg)
    print(f"model: {cfg.n_params()/1e6:.1f}M params ({cfg.n_layers}L x {cfg.d_model}) on {dev}")
    ckpt = tempfile.mkdtemp(prefix="repro_torch_e2e_")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=args.seq)
    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(20, args.steps))

    def mk():
        return Trainer(api, opt, TrainerConfig(ckpt_dir=ckpt, ckpt_every=25, log_every=20), device=dev)

    def loader(start):
        return ShardedLoader(corpus, global_batch=args.batch, host_id=0, n_hosts=1, start_step=start)

    # phase 1: train and CRASH mid-way
    tr = mk()
    tr.init_state()
    half = args.steps // 2
    ld = loader(0)
    try:
        tr.run(ld, args.steps, fail_at=half, on_step=lambda s, m: s % 20 == 0 and print(
            f"  step {s:4d} loss {m['loss']:.4f}"))
    except SimulatedFailure as e:
        print(f"  !! {e} — simulating node failure")
    finally:
        ld.close()
    tr.ckpt.wait()

    # phase 2: a fresh process resumes from the last checkpoint
    tr2 = mk()
    assert tr2.try_restore(), "no checkpoint found"
    print(f"  resumed at step {tr2.step}")
    ld = loader(tr2.step)
    try:
        log = tr2.run(ld, args.steps - tr2.step, on_step=lambda s, m: s % 20 == 0 and print(
            f"  step {s:4d} loss {m['loss']:.4f}"))
    finally:
        ld.close()

    first = np.mean([m["loss"] for m in log[:5]])
    last = np.mean([m["loss"] for m in log[-5:]])
    print(f"loss {first:.4f} -> {last:.4f} over the resumed segment")
    assert last < first
    shutil.rmtree(ckpt, ignore_errors=True)
    print("train_e2e ok (crash -> resume -> loss still falling)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
