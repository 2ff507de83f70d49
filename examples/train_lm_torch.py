"""End-to-end driver on the PyTorch port: train a reduced
assigned-architecture LM for a few hundred steps with checkpoint and
restart (the twin of ``examples/train_lm.py`` on ``repro_torch``).

  PYTHONPATH=src python examples/train_lm_torch.py --arch gemma3-4b \\
      --steps 200                                            # the card
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    losses = train(args.arch, steps=args.steps, use_reduced=True,
                   ckpt_dir=args.ckpt_dir, batch=8, seq=64,
                   ckpt_every=50, log_every=10, device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")


if __name__ == "__main__":
    main()
