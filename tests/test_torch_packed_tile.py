"""The tiled packed backward of csrc/codenerf_packed.cu (kernel 6) in its
plain version, one piece at a time and as a whole backward.

Its two tile pieces, each held against numpy float64 and against autograd
through the forward's `tile_layer_plain`, for every entry of their tables:

* `tile_dx_plain`, an input gradient dX = D W^T with its epilogue (mask,
  grad_mask, outer, accumulate or a plain store), for each entry of
  `PACKED_DX_PIECES`;
* `tile_wgrad_plain`, a weight gradient X^T D with its bias sum, for each
  entry of `PACKED_BWD_LAYERS` (dB2 = t^T dsinarg included).

The CUDA pieces (`cn2_tile_dx`, `cn2_tile_wgrad`) are held against them on
the card by tests/test_torch_cuda_kernels.py (`-k cn2_dx`, `-k cn2_wgrad`),
on the cases `dx_case` and `wgrad_case` make.

`tile_bwd` composes the pieces in csrc/codenerf_packed.cu's order: the
forward recomputed with `tile_layer_plain` a 64-row tile at a time, the
backward's pieces, one partial row of weight gradients a tile and their
sum in tile order. It is held against `codenerf_packed_bwd_plain` and the
JAX package's `_make_codenerf_packed(..., interpret=True)` backward
(`f_bwd`, through `jax.vjp`) at C = 1 and 3 and a ragged N = 100, with the
tolerances of tests/test_torch_packed_field.py.

The backward's cosine (`cos_f32`, sin_f32's reduction with the quadrant
moved by one) is held on the card against float64 by
tests/test_torch_cuda_kernels.py (`-k cn_cos`); here its quadrant rule is
mirrored on sin_f32's large-argument reduction (the word-for-word mirror of
tests/test_torch_codenerf_tile.py) and held against the exact cosine.
This file imports jax only inside the tests that compare with it, so that
the card tests can import `dx_case` and `wgrad_case` on a machine without
jax.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from catnerf_torch.kernels import fused_field as tff
from test_torch_codenerf_tile import (_PI_BITS, _chain_inputs,
                                      _large_reduction, _pi_scaled,
                                      _point_major, _port_inputs,
                                      assert_scaled_close)

torch.set_num_threads(1)

RAGGED_N = 77
CPU_TOL = 1e-5   # float32 against float64, relative to the output's scale
GRAD_TOL = 3e-4  # tests/test_torch_packed_field.py
BWD_SHAPES = ((1, 100), (3, 100))

# each layer's form in the forward chain (TILE_LAYERS) and its key
_FORM = {"r1": "r1", "r0": "r0", "t0": "t0", "vd": "vd", "en": "en",
         "s1": "s1", "c": "c_split", "s0": "s0", "e": "e_split", "sg": "sg"}


def _arrays(rng, shapes: dict) -> tuple[dict, dict]:
    """float32 torch tensors and the same values in float64 numpy."""
    f32 = {k: None if v is None else v.astype(np.float32)
           for k, v in shapes.items()}
    return ({k: None if v is None else torch.tensor(v)
             for k, v in f32.items()},
            {k: None if v is None else v.astype(np.float64)
             for k, v in f32.items()})


def dx_case(piece, N, seed, device="cpu"):
    """One input-gradient piece's inputs: d [N, KIN], w [KOUT, KIN] scaled
    by 1/sqrt(KIN), and the piece's extra input: a [N, KOUT] (a
    pre-activation of either sign), d1 [N, 1] and w1 [KOUT, 1], or acc
    [N, KOUT]. Returns (keyword arguments on `device`, float64 numpy)."""
    _, _, _, kout, kin, epi = tff.packed_dx_spec(piece)
    rng = np.random.default_rng(seed)
    arrays = dict(d=rng.normal(size=(N, kin)),
                  w=rng.normal(size=(kout, kin)) / np.sqrt(kin))
    if epi in ("mask", "grad_mask"):
        arrays["a"] = rng.normal(size=(N, kout))
    elif epi == "outer":
        arrays["d1"] = rng.normal(size=(N, 1)) * 10.0
        arrays["w1"] = rng.normal(size=(kout, 1)) / np.sqrt(kin)
    elif epi == "accumulate":
        arrays["acc"] = rng.normal(size=(N, kout))
    kw, ref = _arrays(rng, arrays)
    return {k: v.to(device) for k, v in kw.items()}, ref


def dx_reference(piece, r):
    """The piece in float64 numpy: (y, dz or None)."""
    epi = tff.packed_dx_spec(piece)[-1]
    y = r["d"] @ r["w"].T
    if epi == "outer":
        y = y + r["d1"] @ r["w1"].T
    elif epi == "accumulate":
        y = y + r["acc"]
    if epi in ("mask", "grad_mask"):
        return y * (r["a"] > 0), y if epi == "grad_mask" else None
    return y, None


def wgrad_case(layer, N, seed, device="cpu"):
    """One weight gradient's inputs: x [N, K] (entries in [-1, 1], as the
    PE's and the activations' scale), d [N, OUT]."""
    _, pieces, out, _ = tff.packed_wgrad_spec(layer)
    rng = np.random.default_rng(seed)
    kw, ref = _arrays(rng, dict(x=rng.uniform(-1, 1, size=(N, sum(pieces))),
                                d=rng.normal(size=(N, out))))
    return {k: v.to(device) for k, v in kw.items()}, ref


def wgrad_reference(layer, r):
    bias = tff.packed_wgrad_spec(layer)[-1]
    return r["x"].T @ r["d"], r["d"].sum(0) if bias else None


@pytest.mark.parametrize("piece", tff.PACKED_DX_NAMES)
def test_tile_dx_plain_matches_float64(piece):
    kw, ref = dx_case(piece, RAGGED_N, seed=11)
    before = dict(tff.LAUNCHES)
    y, dz = tff.cn2_tile_dx(piece, **kw)
    assert tff.LAUNCHES == before  # the CPU takes the plain version
    want_y, want_dz = dx_reference(piece, ref)
    assert y.shape == want_y.shape and y.dtype == torch.float32
    assert_scaled_close(y.numpy(), want_y, CPU_TOL)
    assert (dz is None) == (want_dz is None)
    if dz is not None:
        assert_scaled_close(dz.numpy(), want_dz, CPU_TOL)


def _pre(form, x, w, b):
    """A forward layer's pre-activation ((x_1 w_1 + x_2 w_2) + x_3 w_3) +
    b, as tile_layer_plain sums it."""
    pieces = tff.tile_layer_spec(form)[1]
    acc, k0 = None, 0
    for k in pieces:
        part = x[..., k0:k0 + k] @ w[k0:k0 + k]
        acc = part if acc is None else acc + part
        k0 += k
    return acc + b


def _layer_grad(key, x, w, b, z, g):
    """Autograd through tile_layer_plain for the layer `key` (its forward
    form): the gradients of sum(g * layer(x)) with respect to x and w, b,
    and D, the cotangent at the layer's pre-activation."""
    form = _FORM[key]
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    b = b.detach().requires_grad_()
    epi = tff.tile_layer_spec(form)[-1]
    y = tff.tile_layer_plain(form, x, w, b, z if epi == "relu_add" else None)
    gx, gw, gb = torch.autograd.grad((g * y).sum(), (x, w, b))
    pre = _pre(form, x.detach(), w.detach(), b.detach()).requires_grad_()
    post = {"relu": torch.relu, "relu_add": torch.relu,
            "bias": lambda v: v, "sigma": lambda v: v * 10.0,
            "sigmoid": torch.sigmoid}[epi](pre)
    (D,) = torch.autograd.grad((g * post).sum(), (pre,))
    return gx, gw, gb, D


def _layer_inputs(key, N, rng):
    """A forward layer's input, weights, bias, injection and a cotangent,
    float64 (the autograd checks are about the rule, not the rounding)."""
    K, OUT = next((i, o) for k, i, o in tff.CN_LAYERS if k == key)
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float64)
    return (t(N, K), t(K, OUT) / math.sqrt(K), t(OUT) * 0.1,
            torch.relu(t(N, OUT)), t(N, OUT))


@pytest.mark.parametrize("piece", tff.PACKED_DX_NAMES)
def test_tile_dx_plain_is_the_chain_rule_of_the_forward_layer(piece):
    """Each piece, fed the cotangent D at its layer's pre-activation, gives
    autograd's gradient through tile_layer_plain with respect to its rows
    of the layer's input: through the ReLU and injection that make them
    (mask: relu(a) + z, the gradient at a; grad_mask: also at z), with the
    sigma head's term (outer), and with the cat layer's part of dS
    (accumulate)."""
    _, key, k0, kout, _, epi = tff.packed_dx_spec(piece)
    rng = np.random.default_rng(3)
    N = RAGGED_N
    x, w, b, z, g = _layer_inputs(key, N, rng)
    a = torch.tensor(rng.normal(size=(N, kout)), requires_grad=True)
    zin = torch.relu(torch.tensor(rng.normal(size=(N, kout)))
                     ).requires_grad_()
    x.requires_grad_()
    xin = x
    if epi in ("mask", "grad_mask"):
        xin = torch.cat([x[:, :k0], torch.relu(a) + zin, x[:, k0 + kout:]], 1)
    zl = z if tff.tile_layer_spec(_FORM[key])[-1] == "relu_add" else None
    total = (g * tff.tile_layer_plain(_FORM[key], xin, w, b, zl)).sum()
    D = _layer_grad(key, xin, w, b, z, g)[3]
    kw = {}
    if epi == "outer":  # h also feeds the sigma head
        ws = torch.tensor(rng.normal(size=(32, 1)))
        bs = torch.tensor(rng.normal(size=1))
        gs = torch.tensor(rng.normal(size=(N, 1)))
        total = total + (gs * tff.tile_layer_plain("sg", xin[:, :32], ws, bs)
                         ).sum()
        kw = dict(d1=10.0 * gs, w1=ws)
    elif epi == "accumulate":  # [t | S_lo] also feeds the cat layer
        xc, wc, bc, zc, gc = _layer_inputs("c", N, rng)
        xc = torch.cat([xc[:, :32], xin], 1)
        total = total + (gc * tff.tile_layer_plain("c_split", xc, wc, bc, zc)
                         ).sum()
        Dc = _layer_grad("c", xc, wc, bc, zc, gc)[3]
        kw = dict(acc=tff.tile_dx_plain("c_s", Dc, wc[35:119])[0])
    if epi in ("mask", "grad_mask"):
        kw = dict(a=a.detach())
        want, want_dz = torch.autograd.grad(total, (a, zin))
    else:
        want = torch.autograd.grad(total, (x,))[0][:, k0:k0 + kout]
    got, dz = tff.tile_dx_plain(piece, D, w[k0:k0 + kout], **kw)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    if epi == "grad_mask":
        torch.testing.assert_close(dz, want_dz, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("layer", tff.PACKED_BWD_NAMES)
def test_tile_wgrad_plain_matches_float64(layer):
    kw, ref = wgrad_case(layer, RAGGED_N, seed=13)
    before = dict(tff.LAUNCHES)
    dw, db = tff.cn2_tile_wgrad(layer, **kw)
    assert tff.LAUNCHES == before
    want_w, want_b = wgrad_reference(layer, ref)
    assert dw.shape == want_w.shape and dw.dtype == torch.float32
    assert_scaled_close(dw.numpy(), want_w, CPU_TOL)
    assert (db is None) == (want_b is None)
    if db is not None:
        assert_scaled_close(db.numpy(), want_b, CPU_TOL)


@pytest.mark.parametrize("layer", tff.PACKED_BWD_NAMES)
def test_tile_wgrad_plain_is_the_chain_rule_of_the_forward_layer(layer):
    """Fed the layer's input and the cotangent D at its pre-activation,
    each weight gradient gives autograd's gradient through
    tile_layer_plain with respect to the layer's weights and bias (for b2,
    through S = sin(t B2) with respect to B2)."""
    rng = np.random.default_rng(5)
    N = RAGGED_N
    if layer == "b2":
        t = torch.tensor(rng.normal(size=(N, 3)))
        B2 = torch.tensor(rng.normal(size=(3, tff.N_SLOTS)),
                          requires_grad=True)
        dS = torch.tensor(rng.normal(size=(N, tff.N_SLOTS)))
        (want,) = torch.autograd.grad((dS * torch.sin(t @ B2)).sum(), (B2,))
        got, db = tff.tile_wgrad_plain("b2", t, dS * torch.cos(t @ B2))
        assert db is None
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
        return
    x, w, b, z, g = _layer_inputs(layer, N, rng)
    _, gw, gb, D = _layer_grad(layer, x, w, b, z, g)
    got_w, got_b = tff.tile_wgrad_plain(layer, x, D)
    torch.testing.assert_close(got_w, gw, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got_b, gb, rtol=1e-10, atol=1e-10)


def test_packed_tables_are_the_chain_layers():
    """Every weight gradient at its layer's widths, the split layers' pieces
    as the forward's; the input-gradient pieces of each layer cover its
    rows that the backward reads, in order, at the layer's output width."""
    widths = {k: (i, o) for k, i, o in tff.CN_LAYERS}
    for name, pieces, out, bias in tff.PACKED_BWD_LAYERS:
        if name == "b2":
            assert (pieces, out, bias) == ((3,), tff.N_SLOTS, False)
            continue
        assert (sum(pieces), out, bias) == (*widths[name], True)
    assert [p for p, *_ in tff.PACKED_BWD_LAYERS[:-1]] == [
        "r1", "r0", "t0", "vd", "sg", "en", "s1", "c", "s0", "e"]
    rows: dict[str, list] = {}
    for name, key, k0, kout, epi in tff.PACKED_DX_PIECES:
        assert tff.packed_dx_spec(name)[4] == widths[key][1]
        rows.setdefault(key, []).append((k0, kout))
    for key, spans in rows.items():
        assert spans[0][0] == 0 and all(
            a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert rows["c"][-1] == (35, 84) and rows["e"][-1] == (3, 84)
    assert rows["vd"][-1] == (32, 42)


def test_packed_pieces_reject_unknown_names_and_stray_inputs():
    kw, _ = dx_case("s1", 4, seed=0)
    with pytest.raises(ValueError, match="piece"):
        tff.cn2_tile_dx("s2", **kw)
    with pytest.raises(ValueError, match="takes"):
        tff.cn2_tile_dx_cuda("s1", kw["d"], kw["w"])
    with pytest.raises(ValueError, match="layer"):
        tff.cn2_tile_wgrad("b3", torch.zeros(4, 3), torch.zeros(4, 3))


# --- the whole backward, composed from the plain pieces ---


def tile_bwd(flat, B, pts, zs, dsg, dcol, inv_scale,
             rows=tff.PACKED_BLOCK_ROWS):
    """csrc/codenerf_packed.cu's cn2_bwd_kernel with the plain pieces,
    `rows` rows of every category a tile: the packed forward recomputed
    with tile_layer_plain (kernel 5's tile body), the ReLU's masks kept
    (relu(a) is the layer with no injection, the injection added after, as
    tile_layer's mask epilogue keeps a > 0), then the backward's pieces in
    the kernel's order, one partial row [params | dB2] a tile, and the
    partials summed in tile order (reduce_tiles). Same contract as
    codenerf_packed_bwd_plain."""
    C, N = flat.shape[0], pts.shape[0]
    W, b = tff._unpack(flat, tff.CN_LAYERS)
    b = {k: v.squeeze(-2) for k, v in b.items()}
    B2 = tff.fold_b2(B)
    cat = lambda xs: [tff._to_cat_major(x, C) for x in xs]
    t_all, dsg_all, dcol_all = cat((pts * inv_scale, dsg, dcol))
    dsg_all = dsg_all * 10.0
    z_all = cat(zs)
    total, dpts, dzs = None, [], [[], [], [], []]
    for r0 in range(0, N, rows):
        s = slice(r0, r0 + rows)
        t, z0, z1, z2, z3 = (x[:, s] for x in (t_all, *z_all))
        sinarg = t @ B2
        S = torch.sin(sinarg)
        e1, e2 = torch.cat([t, S[..., :tff._LOW]], -1), S[..., tff._LOW:]

        def fwd(form, key, x, inject=False):
            """relu(a) (r, whose sign is the mask) or the layer's output."""
            zero = torch.zeros_like(z0) if inject else None
            return tff.tile_layer_plain(form, x, W[key], b[key], zero)

        r0_ = fwd("e_split", "e", e1, True)
        g0 = r0_ + z0
        r1 = fwd("s0", "s0", g0, True)
        g1 = r1 + z1
        r2 = fwd("c_split", "c", torch.cat([g1, e1], -1), True)
        g2 = r2 + z2
        r3 = fwd("s1", "s1", g2)
        h = fwd("en", "en", r3)
        r4 = fwd("vd", "vd", torch.cat([h, e2], -1), True)
        g4 = r4 + z3
        r5 = fwd("t0", "t0", g4)
        r6 = fwd("r0", "r0", r5)
        col = fwd("r1", "r1", r6)
        da7 = dcol_all[:, s] * col * (1.0 - col)
        dsg_t = dsg_all[:, s]

        def dx(piece, d, **kw):
            _, key, k0, kout, _, _ = tff.packed_dx_spec(piece)
            return tff.tile_dx_plain(piece, d, W[key][..., k0:k0 + kout, :],
                                     **kw)

        dW, db = {}, {}

        def wgrad(key, x, d):
            dW[key], db[key] = tff.tile_wgrad_plain(key, x, d)

        wgrad("r1", r6, da7)
        da6, _ = dx("r1", da7, a=r6)
        wgrad("r0", r5, da6)
        da5, _ = dx("r0", da6, a=r5)
        wgrad("t0", g4, da5)
        da4, dg4 = dx("t0", da5, a=r4)
        wgrad("vd", torch.cat([h, e2], -1), da4)
        wgrad("sg", h, dsg_t)
        dh, _ = dx("vd_h", da4, d1=dsg_t, w1=W["sg"])
        dS_hi, _ = dx("vd_s", da4)
        wgrad("en", r3, dh)
        da3, _ = dx("en", dh, a=r3)
        wgrad("s1", g2, da3)
        da2, dg2 = dx("s1", da3, a=r2)
        wgrad("c", torch.cat([g1, e1], -1), da2)
        da1, dg1 = dx("c_y", da2, a=r1)
        dt_c, _ = dx("c_t", da2)
        dS_lo, _ = dx("c_s", da2)
        wgrad("s0", g0, da1)
        da0, dg0 = dx("s0", da1, a=r0_)
        wgrad("e", e1, da0)
        dt_e, _ = dx("e_t", da0)
        dS_lo, _ = dx("e_s", da0, acc=dS_lo)
        dsinarg = torch.cat([dS_lo, dS_hi], -1) * torch.cos(sinarg)
        dB2, _ = tff.tile_wgrad_plain("b2", t, dsinarg)
        part = torch.cat([tff._grads_flat(dW, db, tff.CN_LAYERS),
                          dB2.flatten(-2)], -1)
        total = part if total is None else total + part
        dpts.append(((dsinarg @ B2.transpose(-1, -2) + dt_e) + dt_c)
                    * inv_scale)
        for acc, d in zip(dzs, (dg0, dg1, dg2, dg4)):
            acc.append(d)
    return (total[:, :tff.CN_P],
            total[:, tff.CN_P:].reshape(C, 3, tff.N_SLOTS),
            tff.to_point_major(torch.cat(dpts, 1)),
            tuple(tff.to_point_major(torch.cat(d, 1)) for d in dzs))


def _packed_case(C, N, seed):
    """JAX-initialised weights at the basis's init (see
    tests/test_torch_packed_field.py), numpy draws, category-major (as
    _chain_inputs); the cotangents dsg [N, C], dcol [N, 3C]."""
    from catnerf_tpu.models import embedding

    fc, _, pts, zs = _chain_inputs(C, N, seed)
    B = np.stack([embedding.ICOSAHEDRON_DIRS] * C).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    dsg = rng.normal(size=(N, C)).astype(np.float32)
    dcol = rng.normal(size=(N, 3 * C)).astype(np.float32)
    return fc, B, pts, zs, dsg, dcol


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("C,N", BWD_SHAPES)
def test_tile_bwd_matches_the_plain_backward(C, N):
    fc, B, pts, zs, dsg, dcol = _packed_case(C, N, seed=N + C)
    flat, tB, tpts, tzs = _port_inputs(fc, B, pts, zs, packed=True)
    args = (flat, tB, tpts, tzs, torch.tensor(dsg), torch.tensor(dcol), 0.5)
    got = tile_bwd(*args)
    want = tff.codenerf_packed_bwd_plain(*args)
    assert got[0].shape == (C, tff.CN_P) and got[2].shape == (N, 3 * C)
    for x, y in zip(got[:3] + got[3], want[:3] + want[3]):
        assert x.shape == y.shape
        _close(x, y, GRAD_TOL)


@pytest.mark.parametrize("C,N", BWD_SHAPES)
def test_tile_bwd_matches_the_jax_kernel(C, N):
    """Against the Pallas backward `_cn2_bwd_kernel` (:786) in interpret
    mode, reached through jax.vjp of codenerf_packed_apply (tile 32: a
    ragged last tile at N=100): the field layers' gradients, dB (dB2 folded
    back), dpts and the four injections'."""
    import jax
    import jax.numpy as jnp

    from catnerf_torch import convert
    from catnerf_torch.models.codenerf import CodeNeRF
    from catnerf_tpu.experimental import fused_field as jff

    fc, B, pts, zs, dsg, dcol = _packed_case(C, N, seed=N + C)
    flat, tB, tpts, tzs = _port_inputs(fc, B, pts, zs, packed=True)
    got = tile_bwd(flat, tB, tpts, tzs, torch.tensor(dsg),
                   torch.tensor(dcol), 0.5)

    def f(fc, B, pts, zs):
        return jff.codenerf_packed_apply(fc, {"B": B}, pts, *zs, scale=2.0,
                                         tile=32, interpret=True)

    _, vjp = jax.vjp(f, fc, jnp.asarray(B), jnp.asarray(_point_major(pts)),
                     [jnp.asarray(_point_major(z)) for z in zs])
    gfc, gB, gpts, gzs = vjp((jnp.asarray(dsg),
                              jnp.asarray(dcol).reshape(N, C, 3)))
    gflat = tff.pack(tff._cn_modules(CodeNeRF(convert.layers_from_jax(
        jax.tree.map(np.asarray, gfc)))))
    _close(got[0], gflat.detach(), GRAD_TOL)
    _close(tff.unfold_db2(got[1]), gB, GRAD_TOL)
    _close(got[2], gpts, GRAD_TOL)
    for x, y in zip(got[3], gzs):
        _close(x, y, GRAD_TOL)


# --- the backward's cosine (csrc/cn_tile.cuh cos_f32) ---


def _quadrant_value(q: int, r: float) -> float:
    """sincos_f32's polynomial step: sin or cos of r by the quadrant q."""
    v = math.cos(r) if q & 1 else math.sin(r)
    return -v if q & 2 else v


@pytest.mark.parametrize("exponent", [16, 17, 40, 64, 65, 96, 97, 127])
def test_cosine_quadrant_rule_on_the_large_reduction(exponent):
    """cos(x) = the sine's polynomial step at quadrant q + 1 on |x|'s
    reduction (q, r), with no sign from x: on the mirror of the
    Payne-Hanek branch, against the exact cosine from the exact reduction
    (x 2/pi = 4n + k + frac), for float32 arguments of one binary exponent
    and both signs."""
    rng = np.random.default_rng(exponent + 1)
    two_over_pi = Fraction(2 << _PI_BITS, _pi_scaled())
    half_pi = math.pi / 2
    sig = rng.integers(0, 1 << 23, size=200)
    xs = ((np.uint32(exponent + 127) << np.uint32(23)) | sig.astype(
        np.uint32)).view(np.float32)
    xs = np.concatenate([xs, -xs])
    for x in xs[np.abs(xs) > 105615]:
        q, f = _large_reduction(x)
        got = _quadrant_value((q + 1) & 3, f / 2.0**64 * half_pi)
        t = Fraction(float(abs(x))) * two_over_pi
        k = round(t)
        want = math.cos((k % 4) * half_pi + float(t - k) * half_pi)
        assert abs(got - want) < 1e-12, float(x)


def test_cosine_quadrant_rule_on_the_cody_waite_reduction():
    """The same rule on the branch up to 105,615: j = rint(|x| 2/pi), r =
    |x| - j pi/2 in float64, against math.cos, both signs."""
    xs = np.concatenate([np.linspace(-105615, 105615, 20001),
                         np.arange(-200, 200) * (np.pi / 2)])
    for x in xs:
        j = round(abs(x) * 2 / math.pi)
        got = _quadrant_value((j + 1) & 3, abs(x) - j * (math.pi / 2))
        assert abs(got - math.cos(x)) < 1e-9, x
