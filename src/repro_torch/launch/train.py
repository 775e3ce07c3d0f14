"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(``repro.launch.train`` counterpart).

Runs the checkpointed training loop (``repro_torch.training``) on one
device, ``--device cuda`` unless told ``--device cpu``. Rerunning the same
command resumes from the latest committed step under
``<ckpt-dir>/<config name>``. It prints the reference's ``[train]`` lines,
and ``[train] kernel launches:`` (each kernel wrapper's count, JSON): the
loss runs the plain versions, so every count stays 0.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.kernels import kernel_wrappers
from repro_torch.models.zoo import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    print(f"[train] {cfg.name}: {model.num_params():,} params "
          f"({model.active_params():,} active) on 1 device ({args.device})")

    data = SyntheticTokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    )
    tcfg = TrainConfig(
        num_steps=args.steps,
        save_every=args.save_every,
        micro_batches=args.micro_batches,
        adamw=AdamWConfig(lr=args.lr),
        seed=args.seed,
    )
    trainer = Trainer(model, tcfg, data, f"{args.ckpt_dir}/{cfg.name}", device=args.device)
    result = trainer.run()
    print(f"[train] done @ step {result.final_step}; "
          f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f}; "
          f"resumed_from={result.restored_from}; stragglers={len(result.flagged_steps)}")
    print("[train] kernel launches: " + json.dumps({n: f.launches for n, f in kernel_wrappers().items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
