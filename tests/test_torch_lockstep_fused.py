"""The port's tracker and mapper in lockstep with the reference's on the
fused union route (``model.fused_mlp`` / ``fused_composite`` on): the
port's default route, on the CPU through its kernels' plain versions, held
against the reference's Pallas kernels in interpret mode.  The harness and
its tolerances are tests/test_torch_lockstep.py's (check_tracking,
check_mapping); only the route differs: the fused trunks and the whole-
iteration mapping loss (nicer_fused_maploss), which keep the colour
decoder's Fourier matrix fixed in both packages."""
import pytest

from tests import test_torch_lockstep as L


@pytest.fixture(autouse=True)
def _torch_threads():
    with L.two_torch_threads():
        yield


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return L.recorded_reference(tmp_path_factory, fused=True)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    return L.port_slam(reference, tmp_path_factory)


@pytest.mark.parametrize("idx", L.TRACKED)
def test_tracking_in_lockstep_fused(reference, port, idx):
    L.check_tracking(reference, port, idx)


@pytest.mark.parametrize("idx", L.MAPPED)
def test_mapping_in_lockstep_fused(reference, port, idx):
    L.check_mapping(reference, port, idx)
