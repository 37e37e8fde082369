"""The port's tracker and mapper in lockstep with the reference's over a
whole run's window code, on the fused union route (model.fused_mlp /
fused_composite on: the port's default route, held against the
reference's Pallas kernels in interpret mode): the cases of
tests/test_torch_lockstep_window.py, whose docstring sets them out, with
the harness and tolerances of tests/test_torch_lockstep.py."""
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
    return L.recorded_reference(tmp_path_factory, fused=True,
                                make_cfg=L.window_cfg, nudge=False)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    return L.port_slam(reference, tmp_path_factory)


def test_window_coverage_fused(reference):
    L.check_window_coverage(reference, TRACKED, MAPPED)


def test_schedule_in_lockstep_window_fused(reference, tmp_path_factory):
    L.check_schedule(reference, tmp_path_factory)


@pytest.mark.parametrize("idx", TRACKED)
def test_tracking_in_lockstep_window_fused(reference, port, idx):
    L.check_tracking(reference, port, idx)


@pytest.mark.parametrize("idx", MAPPED)
def test_mapping_in_lockstep_window_fused(reference, port, idx):
    L.check_mapping(reference, port, idx)
