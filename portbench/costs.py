"""Work a kernel must do, from what a call computes: the benchmark's own
formulas, frozen here so that a change to the program cannot move them."""
from __future__ import annotations

INT32 = 4


def jet_gain_bytes(trials: int, rows: int, slots: int) -> int:
    """One jet_gain launch over ``trials`` partitions of a level (or of a
    fleet bucket's lanes together): each real adjacency slot's part id read
    once a trial and its weight once, and each real row's part read and
    its three answers (conn_self, best_part, best_conn) written once a
    trial.  ``rows`` counts the level's real vertices and ``slots`` its
    real directed edges, not a padded layout's, so any layout that
    implements the kernel is held to the same work."""
    return INT32 * (trials * slots + slots + 4 * trials * rows)
