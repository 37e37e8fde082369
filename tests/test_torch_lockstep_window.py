"""The port's tracker and mapper in lockstep with the reference's over a
whole run's window code, on the plain union route: the harness and its
tolerances are tests/test_torch_lockstep.py's (check_tracking,
check_mapping), on window_cfg's 12 frames instead of the tiny run's 7.

There, keyframes come every 2nd frame, so a mapped frame ranks several
earlier keyframes by frustum overlap and keeps mapping_window_size - 2 of
them (frame 10 ranks 0, 2, 4 and 6 for three slots), windows hold up to
five frames (with F_max - F frozen padding slots), the union caches are
drawn over that many frames, and each level outgrows its capacity of
4096 points.  Each replayed mapped frame holds the window that
select_window returns from the reference's numpy stream and the overlap
scores it ranks by, exactly; each replayed frame holds each level's
capacity and tile size.  test_window_coverage asserts that the recorded
run reaches all this, and that TRACKED and MAPPED replay every tracked
frame after the first growth and every mapped frame with two or more
candidate keyframes; test_schedule holds the port's run loop (which
frames are tracked, mapped and registered as keyframes, in which
order)."""
import pytest

from tests import test_torch_lockstep as L

TRACKED = list(range(3, 12))     # after the first growth (mapped frame 2)
MAPPED = [2, 4, 6, 8, 10, 11]


@pytest.fixture(autouse=True)
def _torch_threads():
    with L.two_torch_threads():
        yield


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return L.recorded_reference(tmp_path_factory, fused=False,
                                make_cfg=L.window_cfg, nudge=False)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    return L.port_slam(reference, tmp_path_factory)


def test_window_coverage(reference):
    L.check_window_coverage(reference, TRACKED, MAPPED)


def test_schedule_in_lockstep_window(reference, tmp_path_factory):
    L.check_schedule(reference, tmp_path_factory)


@pytest.mark.parametrize("idx", TRACKED)
def test_tracking_in_lockstep_window(reference, port, idx):
    L.check_tracking(reference, port, idx)


@pytest.mark.parametrize("idx", MAPPED)
def test_mapping_in_lockstep_window(reference, port, idx):
    L.check_mapping(reference, port, idx)
