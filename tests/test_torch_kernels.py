"""Hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card.  Marked ``gpu``: they skip (with a reason) where
there is no CUDA device; chip_smoke.py runs the same comparisons at the
main path's shapes.

Tolerances: row top-k bitwise (selection copies existing floats).  Mapping
loss, fused trunks, fused composite and tracker render: values rtol 1e-4
(elementwise, atol 1e-4 of the largest magnitude); cotangents
||kernel - plain|| / ||plain|| <= 1e-4 (f32 sums taken in another order;
a ReLU pre-activation within rounding of 0 can flip one unit's gradient
between the two orders); the
tracker render's d rays, whose rounding the distance weights amplify,
within twice the f32 plain version's distance from the float64 plain
version, in norm and entry by entry (chip_smoke.check_drays).  The
deterministic scatter-add of the feature gathers' backward repeats
bitwise.
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
                                           (1000, 40, 8, False),
                                           (2000, 128, 32, True),
                                           (1000, 256, 48, True),
                                           (1000, 37, 8, False)])
def test_topk_rows_kernel_bitwise(cuda, n, C, k, payload):
    """The main path's shapes, the insertion's tile selection (k = 32), a
    k above 32 (the k-pass kernel) and a ragged C (single-column loads);
    rows all BIG, partly BIG, above BIG, exactly BIG after one entry below
    it, and +inf."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((n, C), generator=g, device=cuda)
    x[::7, 10] = x[::7, 3]
    x[5] = K.BIG
    x[6, C // 3:] = K.BIG
    x[8] = 3e12
    x[10] = 3e12
    x[10, [1, C // 2]] = K.BIG
    x[10, C - 1] = 0.5
    x[12] = float("inf")
    x[12, 3] = 0.125
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


def _maploss_kernel_grads(uf, aff, col, row, okf, geo, Bs, need_wgrads, kw):
    ufk = uf.clone().requires_grad_()
    colk = [w.clone().requires_grad_() for w in col]
    glk, clk = FM.nicer_fused_maploss(ufk, aff, colk, row, okf, geo, Bs,
                                      w_color=0.1, need_wgrads=need_wgrads,
                                      **kw)
    (glk + 0.1 * clk).backward()
    return glk, clk, ufk, colk


@pytest.mark.gpu
@pytest.mark.parametrize("with_color,n,need_wgrads", [
    (True, 600, True), (False, 600, True), (True, 4001, True),
    (True, 600, False)])
def test_maploss_kernels_match_plain(cuda, with_color, n, need_wgrads):
    """Kernels #2 and #3 against the plain version under autograd: colour
    and geometry only, a ragged n (4001 rays, 20005 samples: not a multiple
    of the 64-sample tile) and colour without the weight gradients; two
    launches of kernel #3 on the same inputs agree bit for bit."""
    mcfg, row, uf, okf, aff, geo, col, Bs = _maploss_case(cuda, with_color,
                                                          n=n)
    kw = dict(n_blocks=mcfg.n_blocks, skip=mcfg.skip, with_color=with_color,
              S=5, u=8, C=mcfg.c_dim, coef=0.1, sigmoid_rgb=True,
              use_affine=False)
    glk, clk, ufk, colk = _maploss_kernel_grads(uf, aff, col, row, okf, geo,
                                                Bs, need_wgrads, kw)
    gl2, cl2, uf2, col2 = _maploss_kernel_grads(uf, aff, col, row, okf, geo,
                                                Bs, need_wgrads, kw)
    assert torch.equal(glk, gl2) and torch.equal(clk, cl2)
    assert torch.equal(ufk.grad, uf2.grad)
    if with_color:
        assert all(torch.equal(a.grad, b.grad) for a, b in zip(colk, col2))
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
    if with_color and need_wgrads:
        pairs += [(a.grad, b.grad) for a, b in zip(colk, colp)]
    elif with_color:
        assert not any(a.grad.any() for a in colk)
    for a, b in pairs:
        rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        assert rel <= 1e-4, rel


def _close_rel(a, b, name):
    rel = float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)),
                                               1e-30))
    assert rel <= 1e-4, (name, rel)


def _values_close(a, b, name):
    tol = 1e-4 * float(b.abs().max()) + 1e-6
    assert torch.allclose(a, b, rtol=1e-4, atol=tol), name


@pytest.mark.gpu
@pytest.mark.parametrize("with_color,need_dp,n,need_wgrads", [
    (True, False, 3000, True), (True, True, 3000, True),
    (False, True, 3000, False), (True, False, 20003, True),
    (False, False, 20003, False), (True, False, 3000, False)])
def test_trunks_kernels_match_plain(cuda, with_color, need_dp, n,
                                    need_wgrads):
    """Kernels #4 (forward) and #5 (backward) through their autograd
    wrapper (nicer_fused_color / nicer_fused_geo) against fused_trunks_plain
    and fused_trunks_plain_bwd at the full model width (chip_smoke.py's
    inputs): colour, with the position cotangent, geometry only, a ragged n
    (20003 samples: not a multiple of the 64-sample tile) with colour and
    geometry only, and colour without the weight gradients.  Two runs
    agree bit for bit, and so does the bare forward launcher."""
    import chip_smoke
    I = chip_smoke.trunks_inputs(torch, cuda, n=n)
    mcfg, g_occ, g_rgb, Bs = I["mcfg"], I["g_occ"], I["g_rgb"], I["Bs"]
    geo, col = I["geo"], (I["col"] if with_color else [])
    p, cg, cc = I["p"], I["cg"], I["cc"]
    args = (p, cg, cc if with_color else None, Bs, geo, col, mcfg.n_blocks,
            mcfg.skip, with_color)
    before = dict(_cuda.LAUNCHES)
    occ, rgb, dp, dcg, dcc, dcol = chip_smoke.trunks_via_wrapper(
        I, with_color, need_dp, need_wgrads)
    # through the autograd wrapper: one launch of each kernel
    assert _cuda.LAUNCHES["trunks_fwd"] == before.get("trunks_fwd", 0) + 1
    assert _cuda.LAUNCHES["trunks_bwd"] == before.get("trunks_bwd", 0) + 1
    again = chip_smoke.trunks_via_wrapper(I, with_color, need_dp,
                                          need_wgrads)
    for a, b in zip((occ, rgb, dp, dcg, dcc, *dcol),
                    (*again[:5], *again[5])):
        assert (a is None and b is None) or torch.equal(a, b)
    occ0, rgb0 = FM.fused_trunks_plain(*args)
    dp0, dcg0, dcc0, dcol0 = FM.fused_trunks_plain_bwd(
        *args[:6], g_occ, g_rgb, *args[6:], need_dp, need_wgrads)
    torch.cuda.synchronize()
    _values_close(occ, occ0, "occ")
    _close_rel(dcg, dcg0, "dcg")
    if need_dp:
        _close_rel(dp, dp0, "dp")
    else:
        assert dp is None or not dp.any()
    if with_color:
        _values_close(rgb, rgb0, "rgb")
        _close_rel(dcc, dcc0, "dcc")
    if need_wgrads:
        for i, (a, b) in enumerate(zip(dcol, dcol0)):
            _close_rel(a, b, f"dcol[{i}]")
    else:
        assert all(a is None for a in dcol)
    # the bare launcher counts no launch, and repeats the wrapper's bits
    occ3, rgb3 = FM.launch_trunks(*args, backward=False)
    assert _cuda.LAUNCHES["trunks_fwd"] == before.get("trunks_fwd", 0) + 2
    assert torch.equal(occ3, occ)
    assert torch.equal(rgb3, rgb) if with_color else not rgb3.any()


@pytest.mark.gpu
@pytest.mark.parametrize("use_affine,wmode,n", [(False, 0, 500),
                                                (True, 0, 500),
                                                (False, 1, 500),
                                                (False, 0, 501)])
def test_trackloss_kernels_match_plain(cuda, use_affine, wmode, n):
    """Kernels #8 (forward) and #9 (backward) under autograd against
    trackloss_plain differentiated by autograd, at the full model width
    (chip_smoke.py's inputs, fewer rays; 501 rays: 2505 samples, not a
    multiple of the 64-sample tile).  Two runs of #8 and of #9 agree bit
    for bit, and so does #8's bare launcher."""
    import chip_smoke
    I = chip_smoke.trackloss_inputs(torch, cuda, n=n)
    mcfg, S, K = I["mcfg"], I["S"], I["K"]
    rays, aff, rowc, cfeat = I["rays"], I["aff"], I["rowc"], I["cfeat"]
    geo, col, Bs = I["geo"], I["col"], I["Bs"]
    g_depth, g_color = I["g_depth"], I["g_color"]
    static = (mcfg.n_blocks, mcfg.skip, S, K, mcfg.c_dim, 0.1, wmode,
              use_affine, not use_affine)
    outs = []
    before = dict(_cuda.LAUNCHES)
    for fn in (FM.nicer_fused_trackloss, FM.nicer_fused_trackloss,
               FM.trackloss_plain):
        r = rays.clone().requires_grad_()
        a = aff.clone().requires_grad_()
        d, v, c = fn(r, a, rowc, cfeat, geo, col, Bs, *static)
        torch.autograd.backward([d, c], [g_depth, g_color])
        outs.append((d.detach(), v.detach(), c.detach(), r.grad,
                     a.grad if a.grad is not None else torch.zeros_like(a)))
    torch.cuda.synchronize()
    for name in ("trackloss_fwd", "trackloss_bwd"):
        assert _cuda.LAUNCHES[name] == before.get(name, 0) + 2
    (dk, vk, ck, drk, dak), again, (dp_, vp, cp, drp, dap) = outs
    assert all(torch.equal(x, y) for x, y in zip(outs[0], again))
    kw = dict(zip(("n_blocks", "skip", "S", "K", "C", "coef", "wmode",
                   "use_affine", "sigmoid_plain"), static))
    bare = FM.launch_trackloss(rays, aff, rowc, cfeat, geo, col, Bs,
                               backward=False, **kw)
    assert all(torch.equal(x, y) for x, y in zip(bare, (dk, vk, ck)))
    for name, x, y in (("depth", dk, dp_), ("var", vk, vp),
                       ("color", ck, cp)):
        _values_close(x, y, name)
    # d rays: 1/(d^2+1e-10) enters through its square, so f32 rounding is
    # amplified by the inputs' conditioning; the kernel is held against the
    # plain version in float64, in Frobenius norm and entry by entry, with
    # the f32 plain version's own distance as the yardstick
    print("drays readings", use_affine, wmode,
          chip_smoke.check_drays(I, static, drk, drp))
    if use_affine:
        _close_rel(dak, dap, "daff")
    else:
        assert not dak.any()


@pytest.mark.gpu
@pytest.mark.parametrize("with_color,sigmoid_rgb,n_r", [
    (True, True, 600), (True, False, 600), (False, False, 600),
    (True, True, 601)])
def test_composite_kernels_match_plain(cuda, with_color, sigmoid_rgb, n_r):
    """Kernel #6 through nicer_fused_composite under autograd (its backward
    on kernel #5) against composite_plain under autograd, and kernel #7
    through fused_comp_bwd against composite_bwd_plain, at the full model
    width (chip_smoke.py's inputs, fewer rays; 601 rays: 3005 samples, not
    a multiple of #6's 64-sample tile).  Two runs of the wrapper agree bit
    for bit, and so does #6's bare launcher."""
    import chip_smoke
    I = chip_smoke.composite_inputs(torch, cuda, n_r=n_r)
    before = dict(_cuda.LAUNCHES)
    k = chip_smoke.composite_autograd(I, "wrapper", with_color, sigmoid_rgb)
    assert _cuda.LAUNCHES["composite_fwd"] == \
        before.get("composite_fwd", 0) + 1
    assert _cuda.LAUNCHES["trunks_bwd"] == before.get("trunks_bwd", 0) + 1
    again = chip_smoke.composite_autograd(I, "wrapper", with_color,
                                          sigmoid_rgb)
    assert all(torch.equal(a, b) for a, b in
               zip((*k[:5], *k[5]), (*again[:5], *again[5])))
    p = chip_smoke.composite_autograd(I, "plain", with_color, sigmoid_rgb)
    mcfg, S = I["mcfg"], I["S"]
    args = (I["p"], I["cg"], I["cc"] if with_color else None, I["z"],
            I["pm"], I["Bs"], I["geo"], I["col"] if with_color else [])
    rest = (I["dD"], I["dV"], I["dC"], mcfg.n_blocks, mcfg.skip, with_color,
            S, chip_smoke.COMP_COEF, True, sigmoid_rgb)
    k7 = FM.fused_comp_bwd(*args, *rest)
    assert _cuda.LAUNCHES["composite_bwd"] == \
        before.get("composite_bwd", 0) + 1
    p7 = FM.composite_bwd_plain(*args, *rest)
    bare = FM.launch_composite(*args, *rest[3:7], chip_smoke.COMP_COEF,
                               sigmoid_rgb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bare[:3], k[:3]))
    for name, a, b in (("depth", k[0], p[0]), ("var", k[1], p[1]),
                       ("color", k[2], p[2])):
        _values_close(a, b, name)
    _close_rel(k[3], p[3], "dcg")
    _close_rel(k7[0], p7[0], "k7 dcg")
    if with_color:
        _close_rel(k[4], p[4], "dcc")
        _close_rel(k7[1], p7[1], "k7 dcc")
        for i, (a, b) in enumerate(zip(k[5], p[5])):
            _close_rel(a, b, f"dcol[{i}]")
        for i, (a, b) in enumerate(zip(k7[2], p7[2])):
            _close_rel(a, b, f"k7 dcol[{i}]")
    else:
        assert not k[2].any() and not k7[1].any()


@pytest.mark.gpu
def test_index_add_rows_repeats_bitwise(cuda):
    """The feature gathers' backward scatter-add on the card: the same
    inputs give the same bits on every call, and the CPU's index_add_
    order (each row's sources in their order)."""
    from hpslam_tpu_torch.ops import interpolate as IT
    g = torch.Generator(device=cuda).manual_seed(6)
    idx = torch.randint(0, 500, (8000,), generator=g, device=cuda)
    src = torch.randn((8000, 64), generator=g, device=cuda)
    outs = [IT.index_add_rows(500, idx, src) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    cpu = torch.zeros((500, 64)).index_add_(0, idx.cpu(), src.cpu())
    assert torch.equal(outs[0].cpu(), cpu)
