"""End-to-end training example, PyTorch port (twin of ``train_e2e.py``):
train a small xLSTM for a few hundred steps with the whole substrate —
deterministic data pipeline, AdamW + cosine schedule, async atomic
checkpoints, straggler watchdog, crash-resume.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300] [--device cpu]

Re-running the same command resumes from the latest committed checkpoint
(kill it mid-run to see). The config is xlstm-125m at reduced width; it runs
on the card unless told ``--device cpu``.
"""

import argparse

from repro_torch.configs import get_reduced
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.models.zoo import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="checkpoints/train_e2e_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced("xlstm-125m").replace(d_model=256, num_layers=6, num_heads=4, vocab_size=8192)
    model = build_model(cfg)
    print(f"training {cfg.name}: {model.num_params():,} params, "
          f"{args.steps} steps @ batch {args.batch} × seq {args.seq} on {args.device}")

    data = SyntheticTokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=0)
    )
    tcfg = TrainConfig(num_steps=args.steps, save_every=50, warmup_steps=30, adamw=AdamWConfig(lr=1e-3))
    result = Trainer(model, tcfg, data, args.ckpt, device=args.device).run()
    k = max(1, len(result.losses) // 10)

    def window(xs):
        return sum(xs) / len(xs)

    print(f"resumed from: {result.restored_from}")
    if result.losses:
        print(f"loss: first-{k} avg {window(result.losses[:k]):.4f} -> "
              f"last-{k} avg {window(result.losses[-k:]):.4f}")
    print(f"straggler flags: {len(result.flagged_steps)}")


if __name__ == "__main__":
    main()
