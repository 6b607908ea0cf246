"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no GPU (a CUDA kernel has no CPU
mode). This file imports neither jax nor the JAX package, so it also runs on
a machine with only PyTorch; tests/conftest.py imports jax, so there run it
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Forward within 1e-5, every gradient within 2e-4 (the CodeNeRF backward's:
of its plain version in float64, widened by the float32 plain version's own
error within each layer's block, `grad_bound`), and the backward run twice
bitwise equal (the weight gradients are reduced in a fixed order): the four
kernels of the fused trainer (the CodeNeRF pair at C=8 and N = 1, 77,
3,600, 3,601; the background pair at N = 1, 77, 16,800, 16,801), the
packed-ensemble pair (ragged N included) and the MLP-only kernel (C=8 and
N = 1, 77, 2,100, 2,101, 3,600, bitwise repeatable). The GEMM
block of csrc/gemm_f32.cuh alone, for each layout and epilogue its chains
use: 128 wide (the background's) at 1, 16,800 and 16,801 rows, 32 wide and
batched over C=8 categories (the CodeNeRF backward's) at 1, 3,600 and 3,601
rows; within 2e-4 of the output's scale (sums of up to 16,800 terms),
bitwise repeatable. One layer of the forward chain kernel of
csrc/codenerf_fwd.cu alone (`cn_tile_layer`), for each entry of
`TILE_LAYERS`, at 1, 77 and 3,601 rows, within 1e-5 of the output's scale,
bitwise repeatable; its sine (`cn_sin`) within 2 ulp of float64 over all
float32 exponents. The two tile pieces of the packed backward of
csrc/codenerf_packed.cu alone: each input-gradient piece (`cn2_tile_dx`,
every entry of `PACKED_DX_PIECES`) and each weight gradient
(`cn2_tile_wgrad`, every entry of `PACKED_BWD_LAYERS`) at a full and a
ragged block and at 3,601 rows, within 1e-5 of the output's scale of its
plain version and of float64, bitwise repeatable; its cosine (`cn_cos`)
within 2 ulp of float64 over all float32 exponents. The MLP-only kernel's
load of its embedding alone (`cn_emb_load`) at 1, 77 and 2,101 rows, from a 16-byte aligned start and from one that is not:
bitwise equal to its input, laid out k-major as the chain kernel holds it.
One piece's tests
alone, the quick loop for an edit: `-k codenerf_kernel` (kernels 1-2),
`-k packed_kernels` (5-6), `-k occupancy_kernel` (3-4), `-k gemm_block`
(the 128-wide block), `-k cn_gemm` (the 32-wide block), `-k cn_tile` (a
layer of the forward chain kernel), `-k cn_sin` (its sine), `-k cn2_dx`
and `-k cn2_wgrad` (the packed backward's pieces), `-k cn_cos` (its
cosine), `-k cn_emb` (the MLP-only kernel's load), `-k mlp_kernel` (kernel
7).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from catnerf_torch.kernels import fused_field as tff
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap
from test_torch_codenerf_gemm import (CASE_LIST, block_epilogue,
                                     cn_gemm_case)
from test_torch_codenerf_tile import (assert_scaled_close, emb_case,
                                     tile_case, tile_reference)
from test_torch_occupancy_gemm import EPILOGUES, gemm_case, gemm_epilogue
from test_torch_packed_tile import (dx_case, dx_reference, wgrad_case,
                                    wgrad_reference)

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4


def _close(a, b, tol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 77, 3600, 3601])
def test_cuda_codenerf_kernel_matches_plain(cuda_device, N):
    gen = torch.Generator().manual_seed(N)
    C = 8
    flat = tff.pack(tff._cn_modules(CodeNeRF.init(gen, C))).detach()
    B = UniDirsEmbed.init((C,)).B.detach()
    pts = torch.randn(C, N, 3, generator=gen)
    zs = tuple(torch.relu(torch.randn(C, N, 32, generator=gen))
               for _ in range(4))
    dout = torch.randn(C, N, 4, generator=gen)
    # no gradient from rows at a ReLU's kink (codenerf_relu_margin)
    dout *= (tff.codenerf_relu_margin(flat, B, pts, zs, 0.5) >= 1e-5)[..., None]
    args = [x.to(cuda_device) for x in (flat, B, pts)]
    zd = tuple(z.to(cuda_device) for z in zs)
    dd = dout.to(cuda_device)
    before = tff.LAUNCHES["codenerf_fwd"]
    out = tff.codenerf_fwd(*args, zd, 0.5)
    assert tff.LAUNCHES["codenerf_fwd"] == before + 1
    _close(out, tff.codenerf_fwd_plain(*args, zd, 0.5), FWD_TOL)
    got = tff.codenerf_bwd(*args, zd, dd, 0.5)
    plain = tff.codenerf_bwd_plain(*args, zd, dd, 0.5)
    exact = tff.codenerf_bwd_plain(*(x.double() for x in args),
                                   tuple(z.double() for z in zd),
                                   dd.double(), 0.5)
    again = tff.codenerf_bwd_cuda(*args, zd, dd, 0.5)
    flat3 = lambda r: r[:3] + r[3]
    for i, (x, y, e, z) in enumerate(zip(flat3(got), flat3(plain),
                                         flat3(exact), flat3(again))):
        err = (x.double() - e).abs()
        lim = tff.grad_bound(e, y, GRAD_TOL, tff.CN_LAYERS if i == 0 else None)
        assert bool((err <= lim).all()), (
            f"output {i}: max error {float(err.max()):.3e}, "
            f"{float((err / lim).max()):.2f} x its bound")
        assert torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 77, 16800, 16801])
def test_cuda_occupancy_kernel_matches_plain(cuda_device, N):
    gen = torch.Generator().manual_seed(N)
    flat = tff.pack(tff._oc_modules(OccupancyMap.init(gen))).detach()
    B = UniDirsEmbed.init().B.detach()
    pts = torch.randn(N, 3, generator=gen) * 2.0
    dout = torch.randn(N, 4, generator=gen)
    args = [x.to(cuda_device) for x in (flat, B, pts)]
    dd = dout.to(cuda_device)
    before = tff.LAUNCHES["occupancy_fwd"]
    out = tff.occupancy_fwd(*args, 0.2)
    assert tff.LAUNCHES["occupancy_fwd"] == before + 1
    _close(out, tff.occupancy_fwd_plain(*args, 0.2), FWD_TOL)
    got = tff.occupancy_bwd(*args, dd, 0.2)
    want = tff.occupancy_bwd_plain(*args, dd, 0.2)
    again = tff.occupancy_bwd_cuda(*args, dd, 0.2)
    for x, y, z in zip(got, want, again):
        _close(x, y, GRAD_TOL)
        assert torch.equal(x, z)


def _copy_view(v):
    """A copy of a column view inside a buffer as wide as its own."""
    ld = v.stride(-2)
    off = v.storage_offset() % ld
    buf = torch.zeros(*v.shape[:-1], ld, device=v.device)
    out = buf[..., off:off + v.shape[-1]]
    return out.copy_(v)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16800, 16801])
@pytest.mark.parametrize("layer", ["in", "c"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", tff.GEMM_LAYOUTS)
def test_cuda_gemm_block_matches_plain(cuda_device, layout, epilogue, layer,
                                       M):
    """The 128-wide GEMM block of csrc/occupancy.cu against gemm_plain on the
    card (views at the backward's leading dimensions, ragged edges), and
    twice, bitwise equal."""
    kw, _ = gemm_case(layout, epilogue, layer, M, seed=M, device=cuda_device)
    epi = gemm_epilogue(epilogue)
    c0 = kw.pop("c")
    runs = []
    for _ in range(2):
        c = _copy_view(c0)
        before = tff.LAUNCHES["oc_gemm"]
        tff.oc_gemm(layout, epi, c=c, **kw)
        assert tff.LAUNCHES["oc_gemm"] == before + 1
        runs.append(c)
    want = tff.gemm_plain(layout, epi, c=c0.clone(), **kw)
    torch.cuda.synchronize()
    assert runs[0].stride() == c0.stride()
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(runs[0].cpu().numpy(), want.cpu().numpy(),
                               rtol=GRAD_TOL, atol=GRAD_TOL * scale)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3600, 3601])
@pytest.mark.parametrize("layer", ["e", "c", "r0"])
@pytest.mark.parametrize("layout,epilogue", CASE_LIST)
def test_cuda_cn_gemm_block_matches_plain(cuda_device, layout, epilogue,
                                          layer, M):
    """The 32-wide GEMM block of csrc/codenerf_bwd.cu, batched over C=8
    categories, against gemm_plain on the card (views at the chain's
    leading dimensions, ragged edges), both outputs of the two-output
    epilogues, and twice, bitwise equal."""
    kw, _ = cn_gemm_case(layout, epilogue, layer, 8, M, seed=M,
                         device=cuda_device)
    epi = block_epilogue(epilogue)
    c0, c20 = kw.pop("c"), kw.pop("c2", None)
    runs = []
    for _ in range(2):
        c = _copy_view(c0)
        c2 = None if c20 is None else _copy_view(c20)
        before = tff.LAUNCHES["cn_gemm"]
        tff.cn_gemm(layout, epi, c=c, c2=c2, **kw)
        assert tff.LAUNCHES["cn_gemm"] == before + 1
        runs.append((c, c2))
    want2 = None if c20 is None else c20.clone()
    want = tff.gemm_plain(layout, epi, c=c0.clone(), c2=want2, **kw)
    torch.cuda.synchronize()
    for got, ref in zip(runs[0], (want, want2)):
        if ref is None:
            continue
        scale = max(1.0, float(ref.abs().max()))
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL * scale)
    for x, y in zip(*runs):
        assert x is None or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 77, 3601])
@pytest.mark.parametrize("layer", tff.TILE_LAYER_NAMES)
def test_cuda_cn_tile_layer_matches_plain(cuda_device, layer, N):
    """One layer of csrc/codenerf_fwd.cu's chain kernel alone (its tile
    product and epilogue, or a head) against tile_layer_plain on the card
    and against float64, ragged rows included, and twice, bitwise equal."""
    kw, ref = tile_case(layer, N, seed=N, device=cuda_device)
    runs = []
    for _ in range(2):
        before = tff.LAUNCHES["cn_tile"]
        runs.append(tff.cn_tile_layer(layer, **kw))
        assert tff.LAUNCHES["cn_tile"] == before + 1
    want = tff.tile_layer_plain(layer, **kw)
    torch.cuda.synchronize()
    got = runs[0].cpu().numpy()
    assert_scaled_close(got, want.cpu().numpy(), FWD_TOL)
    assert_scaled_close(got, tile_reference(layer, ref), FWD_TOL)
    assert torch.equal(runs[0], runs[1])


def _trig_arguments():
    """Random float32 bit patterns (every exponent), |x| <= 2,000 densely
    (the PE's range), multiples of pi/2 up to 110,000 and both sides of
    the reduction's branch at 105,615."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=200_000, dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    edge = np.float32(105615)
    x = np.concatenate([
        x[np.isfinite(x)],
        np.linspace(-2000, 2000, 100_001, dtype=np.float32),
        (np.arange(-70_000, 70_000, 7) * (np.pi / 2)).astype(np.float32),
        np.float32([0.0, edge, -edge, np.nextafter(edge, np.float32(2e5)),
                    3.4e38, -3.4e38])])
    return x


def _check_trig(device, kernel, key, fn):
    """kernel(x) within 2 ulp of torch.<fn> in float64 over
    _trig_arguments, launched once; inf and NaN give NaN."""
    x = _trig_arguments()
    xd = torch.tensor(x, device=device)
    before = tff.LAUNCHES[key]
    y = kernel(xd)
    assert tff.LAUNCHES[key] == before + 1
    ref = getattr(torch, fn)(xd.double()).cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(ref), 2.0**-126).astype(np.float32))
    err = np.abs(y.cpu().numpy() - ref) / ulp
    assert err.max() <= 2.0, (float(err.max()), float(x[err.argmax()]))
    special = torch.tensor([np.inf, -np.inf, np.nan], device=device)
    assert torch.isnan(kernel(special)).all()


@pytest.mark.cuda
def test_cuda_cn_sin_matches_float64(cuda_device):
    """The chain kernel's sine (sin_f32, its reduction in registers)."""
    _check_trig(cuda_device, tff.cn_sin, "cn_sin", "sin")


@pytest.mark.cuda
def test_cuda_cn_cos_matches_float64(cuda_device):
    """The packed backward's cosine (cos_f32, sin_f32's reduction with the
    quadrant moved by one)."""
    _check_trig(cuda_device, tff.cn_cos, "cn_cos", "cos")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 77, 3601])
@pytest.mark.parametrize("piece", tff.PACKED_DX_NAMES)
def test_cuda_cn2_dx_piece_matches_plain(cuda_device, piece, N):
    """One input-gradient piece of csrc/codenerf_packed.cu's backward alone
    (its tile product and epilogue) against tile_dx_plain on the card and
    against float64, at a full block, a ragged one and many, and twice,
    bitwise equal."""
    kw, ref = dx_case(piece, N, seed=N, device=cuda_device)
    runs = []
    for _ in range(2):
        before = tff.LAUNCHES["cn2_dx"]
        runs.append(tff.cn2_tile_dx(piece, **kw))
        assert tff.LAUNCHES["cn2_dx"] == before + 1
    want = tff.tile_dx_plain(piece, **kw)
    exact = dx_reference(piece, ref)
    torch.cuda.synchronize()
    for got, again, plain, x64 in zip(runs[0], runs[1], want, exact):
        assert (got is None) == (x64 is None)
        if got is None:
            continue
        assert_scaled_close(got.cpu().numpy(), plain.cpu().numpy(), FWD_TOL)
        assert_scaled_close(got.cpu().numpy(), x64, FWD_TOL)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 100, 3601])
@pytest.mark.parametrize("layer", tff.PACKED_BWD_NAMES)
def test_cuda_cn2_wgrad_matches_plain(cuda_device, layer, N):
    """One weight gradient of csrc/codenerf_packed.cu's backward alone (a
    partial a 64-row block, then reduce_tiles) against tile_wgrad_plain on
    the card and against float64, and twice, bitwise equal."""
    kw, ref = wgrad_case(layer, N, seed=N, device=cuda_device)
    runs = []
    for _ in range(2):
        before = tff.LAUNCHES["cn2_wgrad"]
        runs.append(tff.cn2_tile_wgrad(layer, **kw))
        assert tff.LAUNCHES["cn2_wgrad"] == before + 1
    want = tff.tile_wgrad_plain(layer, **kw)
    exact = wgrad_reference(layer, ref)
    torch.cuda.synchronize()
    for got, again, plain, x64 in zip(runs[0], runs[1], want, exact):
        assert (got is None) == (x64 is None)
        if got is None:
            continue
        assert_scaled_close(got.cpu().numpy(), plain.cpu().numpy(), FWD_TOL)
        assert_scaled_close(got.cpu().numpy(), x64, FWD_TOL)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_fused_apply_gradients_reach_the_modules(cuda_device):
    """Through autograd on the card: the packed-parameter gradient from the
    backward kernel lands on every field layer, as the plain path's does."""
    gen = torch.Generator().manual_seed(0)
    fc = CodeNeRF.init(gen, 2).to(cuda_device)
    pe = UniDirsEmbed.init((2,)).to(cuda_device)
    pts = torch.randn(2, 50, 3, generator=gen).to(cuda_device)
    zs = [torch.relu(torch.randn(2, 50, 32, generator=gen)).to(cuda_device)
          for _ in range(4)]
    s, r = tff.codenerf_fused_apply(fc, pe, pts, *zs, scale=2.0)
    (s.sum() + r.sum()).backward()
    for m in tff._cn_modules(fc):
        assert m.w.grad is not None and torch.isfinite(m.w.grad).all()
    assert pe.B.grad is not None


def _packed(x):
    """[C, N, k] -> point-major [N, C*k]."""
    return x.transpose(0, 1).reshape(x.shape[1], -1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("N,tile", [(100, 32), (2101, 256), (3600, 384),
                                    (2100, 128)])
def test_cuda_packed_kernels_match_plain(cuda_device, N, tile):
    """Kernels 5 and 6 (ragged N included) against the plain versions;
    the backward twice, bitwise equal."""
    gen = torch.Generator().manual_seed(N)
    C = 3
    flat = tff.pack(tff._cn_modules(CodeNeRF.init(gen, C))).detach()
    B = (UniDirsEmbed.init((C,)).B.detach()
         + 0.05 * torch.randn(C, 21, 3, generator=gen))
    pts = _packed(torch.randn(C, N, 3, generator=gen))
    zs = tuple(_packed(torch.relu(torch.randn(C, N, 32, generator=gen)))
               for _ in range(4))
    dsg = torch.randn(N, C, generator=gen)
    dcol = torch.randn(N, 3 * C, generator=gen)
    args = [x.to(cuda_device) for x in (flat, B, pts)]
    zd = tuple(z.to(cuda_device) for z in zs)
    dd = [x.to(cuda_device) for x in (dsg, dcol)]
    before = tff.LAUNCHES["codenerf_packed_fwd"]
    out = tff.codenerf_packed_fwd(*args, zd, 0.5, tile)
    assert tff.LAUNCHES["codenerf_packed_fwd"] == before + 1
    for x, y in zip(out, tff.codenerf_packed_fwd_plain(*args, zd, 0.5)):
        _close(x, y, FWD_TOL)
    got = tff.codenerf_packed_bwd(*args, zd, *dd, 0.5, tile)
    want = tff.codenerf_packed_bwd_plain(*args, zd, *dd, 0.5)
    again = tff.codenerf_packed_bwd_cuda(*args, zd, *dd, 0.5, tile)
    for x, y, z in zip(got[:3] + got[3], want[:3] + want[3],
                       again[:3] + again[3]):
        _close(x, y, GRAD_TOL)
        assert torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 77, 2100, 2101, 3600])
def test_cuda_mlp_kernel_matches_plain(cuda_device, N):
    """At C=8: the chain kernel's embedding rows start 16-byte aligned in
    every category where 4 divides c N + the block's first row (all of
    them at N = 2,100 and 3,600, half or fewer at 1, 77 and 2,101)."""
    gen = torch.Generator().manual_seed(N)
    C = 8
    flat = tff.pack(tff._cn_modules(CodeNeRF.init(gen, C))).detach()
    emb1 = torch.rand(C, N, 87, generator=gen) * 2 - 1
    emb2 = torch.rand(C, N, 42, generator=gen) * 2 - 1
    zs = tuple(torch.relu(torch.randn(C, N, 32, generator=gen))
               for _ in range(4))
    args = [x.to(cuda_device) for x in (flat, emb1, emb2)]
    zd = tuple(z.to(cuda_device) for z in zs)
    before = tff.LAUNCHES["codenerf_mlp_fwd"]
    out = tff.codenerf_mlp_fwd(*args, zd)
    assert tff.LAUNCHES["codenerf_mlp_fwd"] == before + 1
    _close(out, tff.codenerf_mlp_fwd_plain(*args, zd), FWD_TOL)
    assert torch.equal(out, tff.codenerf_mlp_fwd_cuda(*args, zd))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("N", [1, 77, 2101])
def test_cuda_cn_emb_load_matches_plain(cuda_device, N, offset):
    """offset 1: the rows start one row (348 and 168 bytes) into their
    buffers, so no block's rows are 16-byte aligned and the load copies 4
    bytes at a time."""
    emb1, emb2 = emb_case(N + offset, seed=N, device=cuda_device)
    emb1, emb2 = emb1[offset:], emb2[offset:]
    before = tff.LAUNCHES["cn_emb"]
    got = tff.cn_emb_load(emb1, emb2)
    assert tff.LAUNCHES["cn_emb"] == before + 1
    for x, y in zip(got, tff.emb_load_plain(emb1, emb2)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_packed_apply_gradients_reach_the_modules(cuda_device):
    """Through autograd on the card: kernel 6's per-category gradients land
    on every field layer and on the basis (folded back from dB2)."""
    gen = torch.Generator().manual_seed(1)
    fc = CodeNeRF.init(gen, 2).to(cuda_device)
    pe = UniDirsEmbed.init((2,)).to(cuda_device)
    pts = torch.randn(50, 6, generator=gen).to(cuda_device)
    zs = [torch.relu(torch.randn(50, 64, generator=gen)).to(cuda_device)
          for _ in range(4)]
    s, r = tff.codenerf_packed_apply(fc, pe, pts, *zs, scale=2.0, tile=64)
    assert s.shape == (50, 2) and r.shape == (50, 2, 3)
    (s.sum() + r.sum()).backward()
    for m in tff._cn_modules(fc):
        assert m.w.grad is not None and torch.isfinite(m.w.grad).all()
    assert pe.B.grad is not None and torch.isfinite(pe.B.grad).all()
