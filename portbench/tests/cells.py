"""The cells at a size a CPU test run holds."""

from portbench import harness


def small(cell: str) -> tuple:
    """``(workload, configuration)`` of ``cell`` at 3,000 frames, batches of
    200, calls of 2 epochs and, in a sweep, 4 replicas."""
    wl, cfg = harness.load_cell(cell)
    cfg["data"]["n_frames"] = 3000
    cfg["batch_size"] = 200
    wl["epochs_per_call"] = 2
    if "replicas" in wl:
        wl["replicas"] = 4
    return wl, cfg
