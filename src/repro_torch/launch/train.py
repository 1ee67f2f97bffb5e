"""Training driver (mirrors repro/launch/train.py).

On a machine with a CUDA card it trains on the card; ``--device cpu`` runs
a reduced config end-to-end on the CPU with the same code path:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 200 \
      --reduced --device cpu --global-batch 8 --seq-len 64 --ckpt-dir /tmp/ckpt

Fault tolerance: auto-resumes from the newest checkpoint in --ckpt-dir;
crash-inject with --fail-at to exercise it. Straggler flags are printed as
they fire. ``--device`` (default: the card) is the one flag the reference
lacks; the card's resume is bitwise when the process runs deterministic
algorithms (``runtime/trainer.py``).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    opt = AdamWConfig(lr=args.lr, schedule=warmup_cosine(args.warmup, args.steps))
    tr = Trainer(
        api,
        opt,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        device=args.device,
    )
    if not tr.try_restore():
        tr.init_state(args.seed)
        print(f"[train] fresh start: {args.arch} ({cfg.n_params()/1e6:.1f}M params)")
    else:
        print(f"[train] resumed from step {tr.step}")

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=args.seq_len)
    loader = ShardedLoader(
        corpus,
        global_batch=args.global_batch,
        host_id=args.host_id,
        n_hosts=args.n_hosts,
        start_step=tr.step,
    )
    t0 = time.time()

    def on_step(step, m):
        if step % args.log_every == 0:
            tput = args.global_batch * args.seq_len / max(m["dt"], 1e-9)
            print(
                f"step {step:5d} loss {m['loss']:.4f} acc {m.get('accuracy', 0):.3f} "
                f"gnorm {m.get('grad_norm', 0):.2f} {tput:,.0f} tok/s"
                + (" [STRAGGLER]" if m.get("straggler") else "")
            )

    try:
        tr.run(loader, args.steps - tr.step, fail_at=args.fail_at, on_step=on_step)
    finally:
        loader.close()
    tr.save(sync=True)
    print(f"[train] done: step {tr.step} in {time.time()-t0:.1f}s; ckpt -> {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
