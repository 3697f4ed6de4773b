"""Train a reduced LM for a few hundred steps with checkpoint/restart
through the PyTorch / CUDA port — the training substrate behind the
dry-run's production-scale train_step.  The port's counterpart of
``examples/train_tiny.py``.

    PYTHONPATH=src python examples/torch_train_tiny.py
    PYTHONPATH=src python examples/torch_train_tiny.py --device cpu --steps 20

Trains on the card unless given ``--device cpu``.  ``--steps`` shortens
the run; ``--ckpt`` moves the checkpoints (default: a directory in the
temporary directory, ``TMPDIR``) and ``--resume auto`` continues from
the latest one there, the reference's checkpoints included.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_tiny"))
    ap.add_argument("--resume", default=None, choices=["auto"])
    args = ap.parse_args(argv)
    ck = args.ckpt
    out = train_main([
        "--arch", "deepseek-7b", "--reduced",
        "--steps", str(args.steps), "--batch", "8", "--seq", "64",
        "--lr", "3e-3", "--ckpt", ck, "--ckpt-every", "50",
        "--log-every", "20", "--device", args.device,
    ] + (["--resume", args.resume] if args.resume else []))
    losses = out["losses"]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    print(f"checkpoints in {ck}; rerun with --resume auto to continue "
          f"after a failure")
    return out


if __name__ == "__main__":
    main()
