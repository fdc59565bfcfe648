import pytest

from solverbench import roofline


def test_spmv_bytes_are_x_read_and_y_written_once():
    n = 1023 * 1023
    assert roofline.spmv_min_bytes(n, n, 4) == 8 * n
    assert roofline.spmv_min_bytes(10, 20, 8) == 240


def test_least_time_of_the_headline_fine_operator():
    n = 1023 * 1023
    least = roofline.spmv_min_bytes(n, n, 4) / roofline.peak(
        "NVIDIA H100 80GB HBM3", "hbm_bytes_per_s")
    assert least == pytest.approx(2.4992e-6, rel=1e-4)


def test_share_stays_under_100_whenever_the_time_is_not_below_the_bound():
    assert roofline.share(2.5e-6, 10.0e-6) == pytest.approx(25.0)
    assert roofline.share(2.5e-6, 2.5e-6) == pytest.approx(100.0)


def test_unknown_device_has_no_peak():
    assert roofline.peak("cpu", "hbm_bytes_per_s") is None
