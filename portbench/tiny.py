"""A cell at a size the host's checks can hold: the same files and code
paths, k = 8 and graphs of a few thousand vertices.  The checks run it on
the CPU through the kernels' plain versions."""
import sys
from pathlib import Path

PB = Path(__file__).resolve().parent
ROOT = PB.parent
for p in (str(PB), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import bench  # noqa: E402

FLEET = [{"gen": "grid2d", "args": {"rows": 41, "cols": 41}},
         {"gen": "grid2d", "args": {"rows": 43, "cols": 43}},
         {"gen": "small_world", "args": {"n": 3000}, "seed": 2},
         {"gen": "grid3d", "args": {"nx": 13, "ny": 13, "nz": 13}},
         {"gen": "random_geometric", "args": {"n": 2048}, "seed": 4}]
SIZES = {"cube_side": 18, "scale": 12}


def spec(workload: str, root: Path = ROOT) -> "bench.Spec":
    s = bench.Spec(root, workload)
    s.partitioner["k"] = 8
    s.config = dict(s.config, **{k: v for k, v in SIZES.items()
                                 if k in s.config})
    if s.mode == "fleet":
        s.traffic = dict(s.traffic, graphs=FLEET)
    return s
