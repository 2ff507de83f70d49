"""Batched greedy serving with a KV cache on the PyTorch port (the twin of
``examples/serve_lm.py`` on ``repro_torch``).

  PYTHONPATH=src python examples/serve_lm_torch.py --arch yi-6b \\
      --tokens 24                                             # the card
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import serve


def main(argv=None):
    """Serve ``--batch`` random prompts of the reduced ``--arch`` and
    return ``serve``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = serve(args.arch, batch=args.batch, gen_tokens=args.tokens,
                device=args.device)
    print(out)
    return out


if __name__ == "__main__":
    main()
