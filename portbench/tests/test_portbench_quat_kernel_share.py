"""The reader of ``quat_kernel_share`` on counters set by hand."""

import pytest

from portbench import harness


def test_quat_kernel_share_reads_the_counters():
    """The quaternion layer's frames solved by K6 over all its frames, from
    the recorder's counters; None where the program counted none."""
    from colvarsfinder_tpu_torch import logging_utils
    from portbench.metrics import quat_kernel_share

    wl, cfg = harness.load_cell("ala2_transfer.plain")
    ctx = harness.Context("ala2_transfer.plain", wl, cfg, 1.0, 2.0,
                          [{"wall_s": 2.0, "samples": 4, "steps": 2}])
    logging_utils.reset_trace()
    assert quat_kernel_share.read(ctx) is None
    logging_utils.count("cvf.align.quat_kernel", 60)
    assert quat_kernel_share.read(ctx) == 100.0
    logging_utils.count("cvf.align.quat_plain", 20)
    assert quat_kernel_share.read(ctx) == pytest.approx(75.0)
    logging_utils.reset_trace()
