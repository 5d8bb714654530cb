"""The roofline byte counts against counts made by hand."""

import pytest

from otmb_bench import roofline


def test_bicgstab1_iteration_by_hand():
    # (2, 3, 4) = 24 cells; 20 vector streams and 2 x 7 legs
    assert roofline.bicgstab1_iteration_bytes((2, 3, 4), 4, 4) == 24 * (20 * 4 + 14 * 4)
    # a batch of 4 members in f64 reads the legs once a stage
    assert roofline.bicgstab1_iteration_bytes((2, 3, 4), 8, 8, 4) == 24 * (80 * 8 + 14 * 8)


def test_bicgstab2_cycle_by_hand():
    # stages: 5 + 5 + 8 + 7 + 12 vector streams, 4 x 7 legs
    assert roofline.bicgstab2_cycle_bytes((2, 3, 4), 4, 4) == 24 * (37 * 4 + 28 * 4)
    assert roofline.bicgstab2_cycle_bytes((1, 1, 1), 4, 2, 2) == 74 * 4 + 28 * 2


def test_euler_step_by_hand():
    assert roofline.euler_step_bytes((2, 3, 4), 4, 4, 8) == 24 * (16 * 4 + 7 * 4)
    # bf16 legs under f32 tracers
    assert roofline.euler_step_bytes((1, 1, 1), 4, 2, 1) == 2 * 4 + 7 * 2


def test_the_quarter_degree_counts():
    # the 23-stream bound of K5 at B = 8 (10.73 GB, 3.203 ms at 3.35 TB/s)
    quarter = (75, 1080, 1440)
    step = roofline.euler_step_bytes(quarter, 4, 4, 8)
    assert step == 23 * 466_560_000
    assert step / roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == pytest.approx(
        3.2032e-3, rel=1e-4)
    assert roofline.bicgstab2_cycle_bytes(quarter, 4, 4) == 65 * 466_560_000
    assert roofline.peak_bytes_per_s("unknown card") is None
