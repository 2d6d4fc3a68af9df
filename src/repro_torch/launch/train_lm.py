"""End-to-end training driver example: a qwen3-family model trained
with checkpointing + fault tolerance, on the card (``--device cpu``:
the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 200

The counterpart of the JAX package's ``examples/train_lm.py``, with its
flags and defaults: ``launch.train.main`` at SMOKE size (``--full``:
the published config), a checkpoint every 50 steps under ``--ckpt-dir``
(default: ``repro_torch_train_example`` in the temporary directory),
and the assertion that the loss falls.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from . import train


def main(argv=None) -> dict:
    """Trains; returns ``launch.train.main``'s result (``first_loss``,
    ``final_loss``, ``losses``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="qwen3-8b",
                    help="architecture family (SMOKE size unless --full)")
    ap.add_argument("--full", action="store_true",
                    help="the full published config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_example"))
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu")
    args = ap.parse_args(argv)
    result = train.main([
        "--arch", args.arch, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--device", args.device,
    ] + (["--full"] if args.full else []))
    assert result["final_loss"] < result["first_loss"], "loss must drop"
    print("training example finished; checkpoints in", args.ckpt_dir)
    return result


if __name__ == "__main__":
    main()
