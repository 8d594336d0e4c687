"""K5 (grouped pair distances, ``pair_distances_kernel``): the least time
its bytes need at the card's memory rate, over the median device time of
one launch in the profiled slice. Every launch takes one batch of the
configuration's batch size: its frames [B, N, 3] read once and its
distances [B, P] written once, P = N (N - 1) / 2 (the pair list, 8 P
bytes read by every block from cache, is left out)."""

import statistics

F32 = 4


def k5_bytes(batch: int, n_atoms: int, n_pairs: int) -> float:
    """K5's bytes: frames [B, N, 3] in, distances [B, P] out, float32."""
    return F32 * batch * (3 * n_atoms + n_pairs)


def read(ctx):
    tr = ctx.trace
    runs = tr.named("pair_distances_kernel") if tr is not None else []
    if not runs:
        return None
    cfg = ctx.cfg
    bound = ctx.counts.bound_seconds(
        nbytes=k5_bytes(cfg["batch_size"], cfg["n_atoms"], cfg["d_r"]))
    return 100.0 * bound / (statistics.median(e.dur_us for e in runs) * 1e-6)
