"""Hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card.  Marked ``gpu``: they skip (with a reason) where
there is no CUDA device; chip_smoke.py runs the same comparisons at the
main path's shapes.

Tolerances: row top-k bitwise (selection copies existing floats).  Mapping
loss: losses rtol 1e-4; cotangents ||kernel - plain|| / ||plain|| <= 1e-4
(f32 sums taken in another order; a ReLU pre-activation within rounding of
0 can flip one unit's gradient between the two orders).
"""
import numpy as np
import pytest
import torch

from hpslam_tpu_torch import _cuda
from hpslam_tpu_torch.models import decoder as Dec
from hpslam_tpu_torch.ops import fused_mlp as FM
from hpslam_tpu_torch.ops import knn as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from hpslam_tpu_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,C,k,payload", [(4096, 1536, 8, True),
                                           (4093, 128, 12, True),
                                           (2047, 4096, 1, True),
                                           (1000, 40, 8, False)])
def test_topk_rows_kernel_bitwise(cuda, n, C, k, payload):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((n, C), generator=g, device=cuda)
    x[::7, 10] = x[::7, 3]
    x[5] = K.BIG
    x[6, C // 3:] = K.BIG
    p = (torch.randint(0, 1 << 22, (n, C), generator=g, device=cuda).float()
         if payload else None)
    before = _cuda.LAUNCHES["topk_rows"]
    d1, v1 = K.topk_rows(x, p, k)
    assert _cuda.LAUNCHES["topk_rows"] == before + 1
    d0, v0 = K.topk_rows_plain(x, p, k)
    assert torch.equal(d0, d1) and torch.equal(v0, v1)


def _maploss_case(dev, with_color, n=600, S=5, u=8):
    mcfg = Dec.ModelConfig()
    g = torch.Generator(device=dev).manual_seed(3)
    params = Dec.init_nicer(g, mcfg, dev)
    C = mcfg.c_dim
    z = (2.0 + 0.5 * torch.rand((n, 1), generator=g, device=dev)) \
        * torch.linspace(0.96, 1.04, S, device=dev)
    rd = torch.randn((n, 3), generator=g, device=dev)
    pts = rd[:, None] * z[..., None]
    d_gt = z[:, S // 2:S // 2 + 1] * 1.01
    pm = (torch.rand((n, S), generator=g, device=dev) > 0.1).float()
    Wm = torch.rand((n, S, u), generator=g, device=dev)
    Wm = (Wm / Wm.sum(-1, keepdim=True)).reshape(n, S * u)
    row = torch.cat([z, pts.reshape(n, -1), rd, d_gt,
                     torch.rand((n, 3), generator=g, device=dev), pm, Wm,
                     torch.zeros((n, u), device=dev)], 1).contiguous()
    fs = 2 * C if with_color else C
    uf = 0.1 * torch.randn((n, u * fs), generator=g, device=dev)
    okf = torch.ones((n, 1), device=dev)
    aff = torch.zeros((n, 12), device=dev)
    geo = FM.flatten_core(params["geo_fine"]["core"])
    col = FM.flatten_core(params["col_fine"]["core"])
    Bs = (params["geo_fine"]["B"], params["col_fine"]["B"])
    return mcfg, row, uf, okf, aff, geo, col, Bs


@pytest.mark.gpu
@pytest.mark.parametrize("with_color", [True, False])
def test_maploss_kernels_match_plain(cuda, with_color):
    mcfg, row, uf, okf, aff, geo, col, Bs = _maploss_case(cuda, with_color)
    kw = dict(n_blocks=mcfg.n_blocks, skip=mcfg.skip, with_color=with_color,
              S=5, u=8, C=mcfg.c_dim, coef=0.1, sigmoid_rgb=True,
              use_affine=False)
    ufk = uf.clone().requires_grad_()
    colk = [w.clone().requires_grad_() for w in col]
    glk, clk = FM.nicer_fused_maploss(ufk, aff, colk, row, okf, geo, Bs,
                                      w_color=0.1, **kw)
    (glk + 0.1 * clk).backward()
    ufp = uf.clone().requires_grad_()
    colp = [w.clone().requires_grad_() for w in col]
    glp, clp = FM.maploss_plain(ufp, aff, colp, row, okf, geo, Bs, **kw)
    (glp + 0.1 * clp).backward()
    with torch.no_grad():
        before = _cuda.LAUNCHES["maploss_fwd"]
        glf, clf = FM.nicer_fused_maploss(uf, aff, col, row, okf, geo, Bs,
                                          w_color=0.1, **kw)
        assert _cuda.LAUNCHES["maploss_fwd"] == before + 1
    for a, b in ((glk, glp), (clk, clp), (glf, glp), (clf, clp)):
        a, b = float(a.detach()), float(b.detach())
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6)
    pairs = [(ufk.grad, ufp.grad)]
    if with_color:
        pairs += [(a.grad, b.grad) for a, b in zip(colk, colp)]
    for a, b in pairs:
        rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        assert rel <= 1e-4, rel
