"""The CodeNeRF backward's GEMM block (csrc/gemm_f32.cuh at its 32-wide
tile, `cn_gemm`) in its plain version, batched over the categories, and the
chain csrc/codenerf_bwd.cu builds from it.

`gemm_plain` is held against numpy float64 at C=3 categories and a ragged
row count, for each layout and epilogue the chain uses and each layer shape
of the chain (K, the leading dimension and column offset of the buffer the
layer's input lies in, its output width), every operand a view into a wider
buffer as in the chain: the weights and biases at the batch stride of the
flat parameters [C, P]. The CUDA block is held against it on the card by
tests/test_torch_cuda_kernels.py, on the cases `cn_gemm_case` makes.

The chain test composes the block's plain version in csrc/codenerf_bwd.cu's
order (the same buffers, leading dimensions and epilogues) and holds it
against `codenerf_bwd_plain`: it checks the decomposition (the ReLU masks
taken from r and not from r + z, the unmasked injection gradients, the
sigma head's term of dh as a K = 1 product, the split of the cat layer's
input gradient) apart from the CUDA code. This file imports no jax.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from catnerf_torch.kernels import fused_field as tff
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed

torch.set_num_threads(1)

W = 32
P = tff.CN_P
# layer -> (K: its input width, the leading dimension of the buffer its
# input lies in, the column its input starts at, its output width):
# emb1 is the tail of [g1 | emb1] (119), the cat layer reads all of it,
# the viewdir layer [h | emb2] (74), rgb_0 is 16 wide
LAYER_SHAPES = {"e": (87, 119, 32, W), "s0": (W, W, 0, W),
                "c": (119, 119, 0, W), "vd": (74, 74, 0, W),
                "r0": (W, W, 0, 16)}
# the epilogues of each layout the chain uses; store is the mask epilogue
# with no mask
CASES = {"nn": ("bias_relu", "bias", "bias_relu_add"),
         "nt": ("mask", "grad_mask", "accumulate", "store"),
         "tn": ("store",)}
CASE_LIST = tuple((lo, ep) for lo, eps in CASES.items() for ep in eps)
C_CPU = 3
RAGGED_M = 37
CPU_TOL = 1e-5  # float32 against float64, relative to the output's scale


def cn_gemm_case(layout, epilogue, layer, C, M, seed, device="cpu"):
    """One cn_gemm call at a layer's shape, batched over C categories:
      nn: the forward, X [M, K] W [K, n] -> [M, n];
      nt: the input gradient, D [M, n] W^T -> [M, K];
      tn: the weight gradient over M rows, X^T D -> [K, n].
    Every matrix is a view into a wider [C, rows, ld] buffer; the weights
    [C, K, n] and the vectors [C, .] are views into [C, P] at stride P.
    Returns (the call's keyword arguments on `device`, the same inputs in
    float64 numpy)."""
    K, ld_in, off, n = LAYER_SHAPES[layer]
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, d = f32(C, M, ld_in), f32(C, M, W + 5)
    prm = f32(C, P)
    prm[:, :K * n] /= np.sqrt(K)
    w = prm[:, :K * n].reshape(C, K, n)
    if layout == "nn":
        a, c_buf, c_cols = (x, (off, K)), (C, M, W + 3), (0, n)
    elif layout == "nt":
        a, c_buf, c_cols = (d, (0, n)), (C, M, ld_in), (off, K)
    else:
        a, c_buf, c_cols = (x, (off, K)), (C, K, n), (0, n)
    b = (d, (0, n)) if layout == "tn" else None
    N = c_cols[1]
    k = min(W, N)  # the masked columns
    c0 = f32(*c_buf)
    side = f32(C, M, 2 * W)  # mask, z and c2 live in 64-wide buffers

    def view(arr, cols, dev):
        t = torch.tensor(arr, device=dev)
        return t if cols is None else t[..., cols[0]:cols[0] + cols[1]]

    def pick(arr, cols):
        return arr if cols is None else arr[..., cols[0]:cols[0] + cols[1]]

    def weights(dev):
        t = torch.tensor(prm, device=dev)
        return torch.as_strided(t, (C, K, n), (P, n, 1))

    def vec(start, length, dev):  # [C, length] at stride P
        return torch.tensor(prm, device=dev)[:, start:start + length]

    kw = dict(a=view(a[0], a[1], device), c=view(c0, c_cols, device),
              b=weights(device) if b is None else view(b[0], b[1], device))
    ref = dict(a=pick(a[0], a[1]), c=pick(c0, c_cols),
               b=w if b is None else pick(b[0], b[1]))
    base = P - 200  # the vectors: past the weights, below P
    if epilogue.startswith("bias"):
        kw["bias"], ref["bias"] = vec(base, N, device), prm[:, base:base + N]
    if epilogue == "bias_relu_add":
        kw["z"], ref["z"] = view(side, (0, N), device), side[..., :N]
        c2 = f32(C, M, 119)
        kw["c2"], ref["c2"] = view(c2, (0, N), device), c2[..., :N]
    if epilogue in ("mask", "grad_mask"):
        kw["mask"], ref["mask"] = (view(side, (W, k), device),
                                   side[..., W:W + k])
    if epilogue == "grad_mask":
        c2 = f32(C, M, W + 7)
        kw["c2"], ref["c2"] = view(c2, (3, k), device), c2[..., 3:3 + k]
    return kw, {k_: np.asarray(v_, dtype=np.float64) for k_, v_ in ref.items()}


def block_epilogue(epilogue):
    """cn_gemm's epilogue name for a case's."""
    return "mask" if epilogue == "store" else epilogue


def reference(layout, epilogue, r):
    """The case in float64 numpy: (c, c2 or None)."""
    A = np.swapaxes(r["a"], -1, -2) if layout == "tn" else r["a"]
    B = np.swapaxes(r["b"], -1, -2) if layout == "nt" else r["b"]
    p = A @ B
    if epilogue in ("bias_relu", "bias", "bias_relu_add"):
        p = p + r["bias"][:, None, :]
        if epilogue != "bias":
            p = np.maximum(p, 0.0)
        return p, (p + r["z"] if epilogue == "bias_relu_add" else None)
    if epilogue == "accumulate":
        return r["c"] + p, None
    if epilogue == "grad_mask":
        k = r["mask"].shape[-1]
        return p, p[..., :k] * (r["mask"] > 0)
    if epilogue == "store":
        return p, None
    k = r["mask"].shape[-1]
    return np.concatenate([p[..., :k] * (r["mask"] > 0), p[..., k:]],
                          axis=-1), None


def _assert_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=CPU_TOL,
                               atol=CPU_TOL * scale)


@pytest.mark.parametrize("layer", tuple(LAYER_SHAPES))
@pytest.mark.parametrize("layout,epilogue", CASE_LIST)
def test_cn_gemm_plain_matches_float64(layout, epilogue, layer):
    kw, ref = cn_gemm_case(layout, epilogue, layer, C_CPU, RAGGED_M, seed=11)
    c_before = kw["c"].clone()
    out = tff.cn_gemm(layout, block_epilogue(epilogue), **kw)
    assert out.data_ptr() == kw["c"].data_ptr()  # written in place
    want, want2 = reference(layout, epilogue, ref)
    assert out.shape == want.shape
    _assert_close(out, want)
    if want2 is not None:
        _assert_close(kw["c2"], want2)
    if epilogue != "accumulate":  # the old contents are overwritten
        assert not torch.equal(out, c_before)


def test_cn_gemm_cases_are_the_blocks():
    """Every pair the test cases use is one the CUDA entry builds."""
    assert {(lo, block_epilogue(ep)) for lo, ep in CASE_LIST} == set(
        tff.CN_GEMM_CASES)


def test_cn_gemm_rejects_unknown_layout_and_epilogue():
    kw, _ = cn_gemm_case("nn", "bias", "s0", 2, 4, seed=0)
    with pytest.raises(ValueError, match="layout"):
        tff.cn_gemm("tt", "bias", **kw)
    with pytest.raises(ValueError, match="epilogue"):
        tff.cn_gemm("nn", "gelu", **kw)


def _chain_inputs(C, N, seed):
    gen = torch.Generator().manual_seed(seed)
    flat = tff.pack(tff._cn_modules(CodeNeRF.init(gen, C))).detach()
    B = (UniDirsEmbed.init((C,)).B.detach()
         + 0.05 * torch.randn(C, 21, 3, generator=gen))
    pts = torch.randn(C, N, 3, generator=gen) * 0.8
    zs = tuple(torch.relu(torch.randn(C, N, 32, generator=gen))
               for _ in range(4))
    dout = torch.randn(C, N, 4, generator=gen)
    return flat, B, pts, zs, dout


def _gemm_chain_bwd(flat, B, pts, zs, dout, inv_scale):
    """csrc/codenerf_bwd.cu's cn_bwd with the block's plain version: the
    same buffers (the concatenations [g1 | emb1] and [h | emb2] whole),
    products and epilogues, launch by launch."""
    C, N, _ = pts.shape
    g = tff.cn_gemm
    empty = lambda cols: torch.full((C, N, cols), float("nan"))
    Wt, bt = tff._unpack(flat, tff.CN_LAYERS)
    off = {}
    o = 0
    for key, i, n in tff.CN_LAYERS:
        off[key + "_w"] = o
        o += i * n
    for key, _, n in tff.CN_LAYERS:
        off[key + "_b"] = o
        o += n

    def wv(key, rows=None, start=0):  # [C, in, out] view of flat
        i, n = Wt[key].shape[-2:]
        rows = i if rows is None else rows
        return torch.as_strided(flat, (C, rows, n), (P, n, 1),
                                off[key + "_w"] + start * n)

    def bv(key):
        n = bt[key].shape[-1]
        return flat[:, off[key + "_b"]:off[key + "_b"] + n]

    t, proj, emb1, emb2 = tff._embed(pts, B, inv_scale)
    xc, xv = empty(119), empty(74)
    xc[..., W:], xv[..., W:] = emb1, emb2
    r = {k: empty(W) for k in ("r0", "g0", "r1", "r2", "g2", "r3", "r4",
                               "g4", "r5")}
    r6 = empty(16)
    z0, z1, z2, z4 = zs
    g("nn", "bias_relu_add", xc[..., W:], wv("e"), r["r0"], bias=bv("e"),
      z=z0, c2=r["g0"])
    g("nn", "bias_relu_add", r["g0"], wv("s0"), r["r1"], bias=bv("s0"),
      z=z1, c2=xc[..., :W])
    g("nn", "bias_relu_add", xc, wv("c"), r["r2"], bias=bv("c"), z=z2,
      c2=r["g2"])
    g("nn", "bias_relu", r["g2"], wv("s1"), r["r3"], bias=bv("s1"))
    g("nn", "bias", r["r3"], wv("en"), xv[..., :W], bias=bv("en"))
    g("nn", "bias_relu_add", xv, wv("vd"), r["r4"], bias=bv("vd"), z=z4,
      c2=r["g4"])
    g("nn", "bias_relu", r["g4"], wv("t0"), r["r5"], bias=bv("t0"))
    g("nn", "bias_relu", r["r5"], wv("r0"), r6, bias=bv("r0"))
    # head_rows
    col = torch.sigmoid(r6 @ Wt["r1"] + bt["r1"])
    da7 = dout[..., 1:4] * col * (1.0 - col)
    dsg = dout[..., 0] * 10.0
    da6 = (da7 @ Wt["r1"].transpose(-1, -2)) * (r6 > 0)
    d = {k: empty(W) for k in ("da5", "da4", "da3", "da2", "da1", "da0")}
    dz = [empty(W) for _ in range(4)]
    dxv, demb1 = empty(74), empty(87)
    g("nt", "mask", da6, wv("r0"), d["da5"], mask=r["r5"])
    g("nt", "grad_mask", d["da5"], wv("t0"), dz[3], mask=r["r4"],
      c2=d["da4"])
    g("nt", "mask", d["da4"], wv("vd"), dxv)
    g("nt", "accumulate", dsg[..., None], wv("sg"), dxv[..., :W])
    g("nt", "mask", dxv[..., :W], wv("en"), d["da3"], mask=r["r3"])
    g("nt", "grad_mask", d["da3"], wv("s1"), dz[2], mask=r["r2"],
      c2=d["da2"])
    g("nt", "grad_mask", d["da2"], wv("c", W), dz[1], mask=r["r1"],
      c2=d["da1"])
    g("nt", "mask", d["da2"], wv("c", 87, start=W), demb1)
    g("nt", "grad_mask", d["da1"], wv("s0"), dz[0], mask=r["r0"],
      c2=d["da0"])
    g("nt", "accumulate", d["da0"], wv("e"), demb1)
    dpts, dB = tff._embed_bwd(demb1, dxv[..., W:], t, proj, B, inv_scale)
    # wgrad_kernel (one chunk: all rows) and narrow_kernel
    dW, db = {}, {}
    for key, x, dd in (("e", xc[..., W:], d["da0"]), ("s0", r["g0"], d["da1"]),
                       ("c", xc, d["da2"]), ("s1", r["g2"], d["da3"]),
                       ("en", r["r3"], dxv[..., :W]), ("vd", xv, d["da4"]),
                       ("t0", r["g4"], d["da5"]), ("r0", r["r5"], da6)):
        dW[key] = g("tn", "mask", x, dd, torch.empty(Wt[key].shape))
        db[key] = dd.sum(-2)
    dW["sg"], db["sg"] = (xv[..., :W].transpose(-1, -2) @ dsg[..., None],
                          dsg.sum(-1, keepdim=True))
    dW["r1"], db["r1"] = r6.transpose(-1, -2) @ da7, da7.sum(-2)
    return (tff._grads_flat(dW, db, tff.CN_LAYERS), dB, dpts, tuple(dz))


def test_gemm_chain_matches_codenerf_bwd_plain():
    flat, B, pts, zs, dout = _chain_inputs(C_CPU, 45, seed=3)
    got = _gemm_chain_bwd(flat, B, pts, zs, dout, 0.5)
    want = tff.codenerf_bwd_plain(flat, B, pts, zs, dout, 0.5)
    for i, (x, y) in enumerate(zip(got[:3] + got[3], want[:3] + want[3])):
        assert x.shape == y.shape, i
        assert torch.isfinite(x).all(), i
        scale = max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4 * scale,
                                   msg=lambda m, i=i: f"output {i}: {m}")


def test_relu_margin_is_the_smallest_pre_activation():
    """codenerf_relu_margin: each row's smallest |pre-activation| over the
    chain's ReLU layers, the first layer's among them."""
    flat, B, pts, zs, _ = _chain_inputs(2, 20, seed=5)
    m = tff.codenerf_relu_margin(flat, B, pts, zs, 0.5)
    W, b = tff._unpack(flat.double(), tff.CN_LAYERS)
    _, _, emb1, _ = tff._embed(pts.double(), B.double(), 0.5)
    first = (emb1 @ W["e"] + b["e"]).abs().amin(-1)
    assert m.shape == (2, 20) and m.dtype == torch.float64
    assert bool((m >= 0).all()) and bool((m <= first).all())
    assert bool((m < first).any())  # a later layer comes closer to zero
