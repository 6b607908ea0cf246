"""The background chain's GEMM block (csrc/gemm_f32.cuh at its 128-wide
tile, `oc_gemm` of csrc/occupancy.cu) in its plain version, and the ctypes
signatures of every kernel library.

`gemm_plain` is held against numpy float64 for its three operand layouts
and the epilogues oc_gemm builds (the mask one with and without its rank-1
term), at the five layers' shapes of the backward (K, the leading dimension
of the layer's input buffer, that of its output buffer) and a ragged row
count.
The CUDA block is held against it on the card by
tests/test_torch_cuda_kernels.py, on the cases `gemm_case` makes. This
file imports no jax.

The signature test parses every `extern "C"` function of each
`csrc/*.cu` and holds its parameters to the ctypes argument types the
wrapper declares: a pointer declared as an int would be cut to 32 bits.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from catnerf_torch.kernels import build
from catnerf_torch.kernels import fused_field as tff

torch.set_num_threads(1)

H = 128
# layer -> (K: its input width, the leading dimension of the buffer its
# input lies in, that of the buffer its output (and output delta) lies in):
# emb1 is the tail of [r1 | emb1] (215), r3 and emb2 share [r3 | emb2]
# (170), r1 and delta1 lie in 215-wide buffers, r3 and delta3 in 170-wide
LAYER_SHAPES = {"in": (87, 215, 128), "m1": (128, 128, 215),
                "c": (215, 215, 128), "m2": (128, 128, 170),
                "cl": (170, 170, 128)}
EPILOGUES = ("bias_relu", "mask", "mask_rank1", "accumulate")
RAGGED_M = 37
CPU_TOL = 1e-5  # float32 against float64, relative to the output's scale


def gemm_case(layout, epilogue, layer, M, seed, device="cpu"):
    """One oc_gemm call at a layer's shape, its matrices views into wider
    buffers at the layer's leading dimensions (as in the backward):
      nn: the forward, X [M, K] W [K, 128] -> [M, 128];
      nt: the input gradient, D [M, 128] W^T -> [M, K];
      tn: the weight gradient over M rows, X^T D -> [K, 128].
    Returns (the call's keyword arguments on `device`, the same inputs in
    float64 numpy)."""
    K, ld_in, ld_out = LAYER_SHAPES[layer]
    rng = np.random.default_rng(seed)
    off = ld_in - K  # emb1 at the tail of its buffer
    x = rng.normal(size=(M, ld_in)).astype(np.float32)
    d = rng.normal(size=(M, ld_out)).astype(np.float32)
    w = (rng.normal(size=(K, H)) / np.sqrt(K)).astype(np.float32)
    if layout == "nn":
        a, b, c_buf, c_cols = (x, (off, K)), (w, None), (M, ld_out), (0, H)
    elif layout == "nt":
        a, b, c_buf, c_cols = (d, (0, H)), (w, None), (M, ld_in), (off, K)
    else:
        a, b, c_buf, c_cols = (x, (off, K)), (d, (0, H)), (K, H), (0, H)
    Mc, N = c_buf[0], c_cols[1]
    c0 = rng.normal(size=c_buf).astype(np.float32)
    mask_cols = min(H, N)
    mask = rng.normal(size=c_buf).astype(np.float32)
    vecs = dict(bias=rng.normal(size=N).astype(np.float32),
                u=rng.normal(size=Mc).astype(np.float32),
                v=rng.normal(size=mask_cols).astype(np.float32))

    def view(arr, cols, dev):
        t = torch.tensor(arr, device=dev)
        return t if cols is None else t[:, cols[0]:cols[0] + cols[1]]

    def pick(arr, cols):
        return arr if cols is None else arr[:, cols[0]:cols[0] + cols[1]]

    mcols = (c_cols[0], mask_cols)
    kw = dict(a=view(a[0], a[1], device), b=view(b[0], b[1], device),
              c=view(c0, c_cols, device))
    ref = dict(a=pick(a[0], a[1]), b=pick(b[0], b[1]), c=pick(c0, c_cols))
    if epilogue == "bias_relu":
        kw["bias"], ref["bias"] = (torch.tensor(vecs["bias"], device=device),
                                   vecs["bias"])
    elif epilogue.startswith("mask"):
        kw["mask"], ref["mask"] = view(mask, mcols, device), pick(mask, mcols)
        if epilogue == "mask_rank1":
            for k in ("u", "v"):
                kw[k] = torch.tensor(vecs[k], device=device)
                ref[k] = vecs[k]
    return kw, {k: np.asarray(v, dtype=np.float64) for k, v in ref.items()}


def gemm_epilogue(epilogue):
    """oc_gemm's epilogue name for a case's (mask_rank1 is mask)."""
    return "mask" if epilogue.startswith("mask") else epilogue


def reference(layout, epilogue, r):
    """The case in float64 numpy."""
    A = r["a"].T if layout == "tn" else r["a"]
    B = r["b"].T if layout == "nt" else r["b"]
    p = A @ B
    if epilogue == "bias_relu":
        return np.maximum(p + r["bias"], 0.0)
    if epilogue == "accumulate":
        return r["c"] + p
    k = r["mask"].shape[1]
    head = p[:, :k] + (np.outer(r["u"], r["v"]) if "u" in r else 0.0)
    return np.concatenate([head * (r["mask"] > 0), p[:, k:]], axis=1)


@pytest.mark.parametrize("layer", tuple(LAYER_SHAPES))
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", tff.GEMM_LAYOUTS)
def test_gemm_plain_matches_float64(layout, epilogue, layer):
    kw, ref = gemm_case(layout, epilogue, layer, RAGGED_M, seed=7)
    c_before = kw["c"].clone()
    out = tff.oc_gemm(layout, gemm_epilogue(epilogue), **kw)
    assert out.data_ptr() == kw["c"].data_ptr()  # written in place
    want = reference(layout, epilogue, ref)
    assert out.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out.numpy(), want, rtol=CPU_TOL,
                               atol=CPU_TOL * scale)
    if epilogue != "accumulate":  # the old contents are overwritten
        assert not torch.equal(out, c_before)


def test_gemm_plain_without_mask_stores():
    """The mask epilogue with no mask is a plain store (the weight
    gradients' partials)."""
    kw, ref = gemm_case("tn", "mask", "c", RAGGED_M, seed=3)
    kw.pop("mask")
    out = tff.oc_gemm("tn", "mask", **kw)
    np.testing.assert_allclose(out.numpy(), ref["a"].T @ ref["b"],
                               rtol=CPU_TOL, atol=CPU_TOL * 10)


def test_gemm_rejects_unknown_layout_and_epilogue():
    kw, _ = gemm_case("nn", "accumulate", "m1", 4, seed=0)
    with pytest.raises(ValueError, match="layout"):
        tff.oc_gemm("tt", "accumulate", **kw)
    with pytest.raises(ValueError, match="epilogue"):
        tff.oc_gemm("nn", "gelu", **kw)


def _exports(source: str) -> dict[str, list[str]]:
    """Each function of the source's extern "C" block -> the kinds of its
    parameters: 'p' a pointer, 'i' an int, 'f' a float."""
    block = source.split('extern "C" {', 1)[1]
    out = {}
    for m in re.finditer(r"^int\s+(\w+)\s*\(([^)]*)\)\s*\{", block, re.M):
        params = [x.strip() for x in m.group(2).split(",") if x.strip()]
        out[m.group(1)] = ["p" if "*" in x else
                           "f" if x.split()[0] == "float" else "i"
                           for x in params]
    return out


def _kind(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "p"
    return {ctypes.c_int: "i", ctypes.c_float: "f"}[t]


def test_libraries_name_every_source():
    assert set(tff.LIBRARIES) == {p.stem for p in build.CSRC.glob("*.cu")}


@pytest.mark.parametrize("lib", tff.LIBRARIES)
def test_ctypes_signatures_match_the_sources(lib):
    exports = _exports((build.CSRC / f"{lib}.cu").read_text())
    declared = {name: [_kind(t) for t in args]
                for name, args in tff._SIGNATURES[lib].items()}
    assert exports == declared
    assert tff._LAYOUT_FNS[lib][0] in exports
