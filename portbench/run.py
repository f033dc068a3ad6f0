"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The kernels build into the checkout's
``src/repro_torch/kernels/_build/``; every other cache a library may keep
goes under ``portbench/.cache/``.  See ``portbench/README.md``.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
sys.path.insert(0, HERE)

import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(t_start=T_START))
