"""Batched LM serving with the PyTorch/CUDA port: prefill + greedy decode
with a KV cache (MLA archs use the compressed-cache absorbed-projection
path), on the arch's smoke config with seeded random weights.

    PYTHONPATH=src python examples/torch_serve_lm.py \
        [--arch deepseek-v2-lite-16b] [--device cuda|cpu]
"""
import argparse

from repro_torch.launch import serve as serve_launch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a card) or cpu")
    args = ap.parse_args(argv)
    return serve_launch.main(["--arch", args.arch, "--batch", "4",
                              "--prompt-len", "24", "--gen", "12",
                              "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
