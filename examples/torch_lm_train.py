"""End-to-end LM training with the PyTorch/CUDA port: the arch's smoke
config (seeded random weights) through the full production loop (AdamW and
its schedule, checkpointing, the straggler watchdog).

    PYTHONPATH=src python examples/torch_lm_train.py [--steps 300] \
        [--arch gemma3-1b] [--device cuda|cpu] [--ckpt-dir DIR]
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_launch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a card) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_train_example"))
    args = ap.parse_args(argv)
    return train_launch.main([
        "--arch", args.arch, "--steps", str(args.steps),
        "--ckpt-dir", args.ckpt_dir, "--device", args.device,
    ])


if __name__ == "__main__":
    raise SystemExit(main())
