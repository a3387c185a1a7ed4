"""The work of one rank of a cell over several cards, counted from shapes
for the per-layer metrics that hold a rank's kernels against a peak (the
arithmetic of ``work.py``, which stays as it is, for the mesh).  Nothing
here touches a device."""

from __future__ import annotations


def gram_flops_rank(sizes):
    """f32 FLOPs that the sharded in-memory Gram needs, a rank's share:
    the distinct entries of the symmetric ``C = X^T X`` of ``Ns``
    snapshots over ``3 * jma * kma`` rows, ``rows * Ns * (Ns + 1)`` (a
    syrk's count: each off-diagonal pair of entries once, the diagonal
    blocks at half), over the ``shard_time * shard_space`` ranks.  This is
    the work the Gram needs, not what an implementation executes: one that
    forms each rank's whole strip (the off-diagonal blocks on both ``t``
    ranks, the diagonal blocks in full) executes about twice it, and one
    that uses the symmetry raises the share without a new count."""
    ranks = int(sizes.get("shard_time", 1)) * int(sizes.get("shard_space", 1))
    ns = int(sizes["nsteps"])
    rows = 3 * int(sizes["jma"]) * int(sizes["kma"])
    return float(rows) * ns * (ns + 1) / ranks
