"""Share of the frames that the program's ``AlignmentLayer(method=
'quaternion')`` solved through its kernel (K6 on a float32 CUDA tensor):
the recorder's ``cvf.align.quat_kernel`` over it plus
``cvf.align.quat_plain`` (frames solved by the plain chain), over the whole
process, replays included. None for a program without those counters."""


def read(ctx):
    try:
        from colvarsfinder_tpu_torch import logging_utils
    except ImportError:
        return None
    counters = getattr(logging_utils, "counters", None)
    if counters is None:
        return None
    now = counters()
    kernel = now.get("cvf.align.quat_kernel", 0)
    total = kernel + now.get("cvf.align.quat_plain", 0)
    return 100.0 * kernel / total if total else None
