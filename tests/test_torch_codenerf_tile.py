"""The forward chain kernel of csrc/codenerf_fwd.cu (kernels 1, 5 and 7) in
its plain version, one layer at a time and as a whole chain.

`tile_layer_plain`, one layer of the chain kernel (the products of the
input's pieces added in order, the bias, then the layer's epilogue: ReLU
and the injection, ReLU, none, the sigma head's x10 or the rgb head's
sigmoid), is held against numpy float64 for each entry of `TILE_LAYERS`
(the chain's ten layers and the packed forward's split forms of the
encoding and cat layers) at a ragged row count. The CUDA layer
(`cn_tile_layer`) is held against it on the card by
tests/test_torch_cuda_kernels.py (`-k cn_tile`), on the cases `tile_case`
makes.

The chain test composes `tile_layer_plain` in csrc/codenerf_fwd.cu's
order (each form's PE, then the layers with their pieces, injections and
epilogues, the heads last), for the kernel's three forms (kernel 1's PE
and kernel 5's, each at its I/O layout, and kernel 7's embedding given as
it is), and holds it within 1e-5 against the port's plain versions
(`codenerf_fwd_plain`, `codenerf_packed_fwd_plain`,
`codenerf_mlp_fwd_plain`) and the JAX package's Pallas kernels in
interpret mode (`codenerf_fused_apply`, `codenerf_packed_apply`, as
tests/test_torch_fused_field.py and tests/test_torch_packed_field.py run
them; for kernel 7, whose Pallas kernel is a closure of
scripts/exp_kernel2.py, the chain it runs, `_codenerf_chain` over
`_cn_param_arrays`), at C=2-3 and N=37-130. Kernel 7's load of its
embedding (`emb_load_plain`: each 64-row block k-major, as the chain kernel
holds it) is held against numpy here, and the CUDA load (`cn_emb_load`)
against it on the card (`-k cn_emb`). This file imports jax only inside
the tests that compare with it, so that the card tests can import
`tile_case` on a machine without jax.

The chain kernel's sine (`sin_f32`, which keeps its Payne-Hanek reduction
in registers) is held on the card against float64 by
tests/test_torch_cuda_kernels.py (`-k cn_sin`); here its constants are
held to pi computed in integers, and its reduction of arguments beyond
105,615 is mirrored word for word in Python integers and held against the
exact reduction.
"""

from __future__ import annotations

import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from catnerf_torch.kernels import build
from catnerf_torch.kernels import fused_field as tff

torch.set_num_threads(1)

RAGGED_N = 77
CPU_TOL = 1e-5   # float32 against float64, relative to the output's scale
FWD_TOL = 1e-5   # the chain against the plain versions and the JAX kernels
CHAIN_SHAPES = ((2, 37), (3, 130))
# the chain kernel's forms: kernel 1 (cn_fwd), kernel 5 (cn2_fwd), kernel 7
# (cn_mlp_fwd)
FORMS = ("cn_fwd", "cn2_fwd", "cn_mlp_fwd")


def tile_case(layer, N, seed, device="cpu"):
    """One layer's inputs: x [N, K] (its pieces side by side, the PE's
    entries in [-1, 1] as sines are), w [K, OUT] scaled by 1/sqrt(K), bias
    [OUT], z [N, OUT] >= 0 for a relu_add layer (else None). Returns (the
    keyword arguments on `device`, the same in float64 numpy)."""
    _, pieces, out, epi = tff.tile_layer_spec(layer)
    K = sum(pieces)
    rng = np.random.default_rng(seed)
    arrays = dict(
        x=rng.uniform(-1.0, 1.0, size=(N, K)),
        w=rng.normal(size=(K, out)) / np.sqrt(K),
        bias=rng.normal(size=out) * 0.1,
        z=np.maximum(rng.normal(size=(N, out)), 0.0) if epi == "relu_add"
        else None)
    f32 = {k: None if v is None else v.astype(np.float32)
           for k, v in arrays.items()}
    kw = {k: None if v is None else torch.tensor(v, device=device)
          for k, v in f32.items()}
    ref = {k: None if v is None else v.astype(np.float64)
           for k, v in f32.items()}
    return kw, ref


def tile_reference(layer, r):
    """The layer in float64 numpy."""
    _, pieces, _, epi = tff.tile_layer_spec(layer)
    y, k0 = 0.0, 0
    for k in pieces:
        y = y + r["x"][:, k0:k0 + k] @ r["w"][k0:k0 + k]
        k0 += k
    y = y + r["bias"]
    if epi in ("relu", "relu_add"):
        y = np.maximum(y, 0.0)
    if epi == "relu_add":
        y = y + r["z"]
    elif epi == "sigma":
        y = y * 10.0
    elif epi == "sigmoid":
        y = 1.0 / (1.0 + np.exp(-y))
    return y


def assert_scaled_close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("layer", tff.TILE_LAYER_NAMES)
def test_tile_layer_plain_matches_float64(layer):
    kw, ref = tile_case(layer, RAGGED_N, seed=7)
    before = dict(tff.LAUNCHES)
    y = tff.cn_tile_layer(layer, **kw)
    assert tff.LAUNCHES == before  # the CPU takes the plain version
    _, _, out, _ = tff.tile_layer_spec(layer)
    assert y.shape == (RAGGED_N, out) and y.dtype == torch.float32
    assert_scaled_close(y.numpy(), tile_reference(layer, ref), CPU_TOL)


def test_tile_layers_are_the_chain_layers():
    """Every CodeNeRF layer, at its fan-in and fan-out, once in the first
    ten entries and in the chain's order; the split forms keep their
    layer's widths."""
    spec = {name: (sum(p), out) for name, p, out, _ in tff.TILE_LAYERS}
    assert [n for n, *_ in tff.TILE_LAYERS[:10]] == [
        k for k, _, _ in tff.CN_LAYERS]
    for key, fan_in, fan_out in tff.CN_LAYERS:
        assert spec[key] == (fan_in, fan_out)
    assert spec["e_split"] == spec["e"] and spec["c_split"] == spec["c"]


def test_tile_layer_rejects_an_unknown_layer_and_a_stray_injection():
    kw, _ = tile_case("s1", 4, seed=0)
    with pytest.raises(ValueError, match="layer"):
        tff.cn_tile_layer("s2", **kw)
    kw["z"] = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="z only"):
        tff.cn_tile_layer_cuda("s1", **kw)


def _chain_inputs(C, N, seed):
    """JAX-initialised CodeNeRF weights, a perturbed basis, and numpy
    draws, category-major."""
    import jax
    import jax.numpy as jnp

    from catnerf_tpu.models import codenerf, embedding

    rng = np.random.default_rng(seed)
    fc = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        codenerf.init_params(k, latent_dim=64)
        for k in jax.random.split(jax.random.PRNGKey(seed), C)])
    B = (np.stack([embedding.ICOSAHEDRON_DIRS] * C)
         + 0.05 * rng.normal(size=(C, 21, 3))).astype(np.float32)
    pts = rng.normal(size=(C, N, 3)).astype(np.float32)
    zs = [np.maximum(rng.normal(size=(C, N, 32)), 0).astype(np.float32)
          for _ in range(4)]
    return fc, B, pts, zs


def _point_major(x):
    """[C, N, k] -> [N, C*k]."""
    return np.ascontiguousarray(np.swapaxes(x, 0, 1).reshape(x.shape[1], -1))


def tile_chain(form, flat, zs, B=None, pts=None, inv_scale=None, emb=None):
    """csrc/codenerf_fwd.cu's chain_kernel with tile_layer_plain, layer by
    layer in its order. cn_fwd: category-major pts [C,N,3], z* [C,N,32];
    proj = t B^T rounded as written, sin(pi 2^f proj) -> [C,N,4]; cn2_fwd:
    point-major pts [N,3C], z* [N,32C]; S = sin(t B2), the encoding and cat
    layers split -> (sg [N,C], col [N,3C]); cn_mlp_fwd: emb = (emb1
    [C,N,87], emb2 [C,N,42]) as given, z* [C,N,32] -> [C,N,4]."""
    C = flat.shape[0]
    W, b = tff._unpack(flat, tff.CN_LAYERS)
    packed = form == "cn2_fwd"
    if packed:
        t = tff._to_cat_major(pts, C) * inv_scale
        S = torch.sin(t @ tff.fold_b2(B))
        emb1 = torch.cat([t, S[..., :tff._LOW]], dim=-1)
        emb2 = S[..., tff._LOW:]
        z0, z1, z2, z3 = (tff._to_cat_major(z, C) for z in zs)
    elif form == "cn_mlp_fwd":
        emb1, emb2 = emb
        z0, z1, z2, z3 = zs
    else:
        _, _, emb1, emb2 = tff._embed(pts, B, inv_scale)
        z0, z1, z2, z3 = zs

    def layer(name, key, x, z=None):
        return tff.tile_layer_plain(name, x, W[key], b[key].squeeze(-2), z)

    g0 = layer("e_split" if packed else "e", "e", emb1, z0)
    g1 = layer("s0", "s0", g0, z1)
    g2 = layer("c_split" if packed else "c", "c",
               torch.cat([g1, emb1], dim=-1), z2)
    r3 = layer("s1", "s1", g2)
    h = layer("en", "en", r3)
    sg = layer("sg", "sg", h)
    g4 = layer("vd", "vd", torch.cat([h, emb2], dim=-1), z3)
    r5 = layer("t0", "t0", g4)
    r6 = layer("r0", "r0", r5)
    col = layer("r1", "r1", r6)
    if packed:
        return tff.to_point_major(sg), tff.to_point_major(col)
    return torch.cat([sg, col], dim=-1)


def _port_inputs(fc, B, pts, zs, packed):
    import jax

    from catnerf_torch import convert
    from catnerf_torch.models.codenerf import CodeNeRF

    tfc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    flat = tff.pack(tff._cn_modules(tfc)).detach()
    lay = _point_major if packed else (lambda x: x)
    return (flat, torch.tensor(B), torch.tensor(lay(pts)),
            tuple(torch.tensor(lay(z)) for z in zs))


def _mlp_embedding(B, pts):
    """Kernel 7's embedding as exp_kernel2.py:96 computes it: the XLA
    path's `embedding.apply` (sinpi polynomial) at scale 2, per category;
    (emb1 [C,N,87], emb2 [C,N,42]) in numpy."""
    import jax
    import jax.numpy as jnp

    from catnerf_tpu.models import embedding

    emb = np.asarray(jax.vmap(
        lambda b, p: embedding.apply({"B": b}, p, scale=2.0))(
            jnp.asarray(B), jnp.asarray(pts)))
    return (np.ascontiguousarray(emb[..., :87]),
            np.ascontiguousarray(emb[..., 87:]))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("C,N", CHAIN_SHAPES)
def test_tile_chain_matches_the_plain_forward(form, C, N):
    fc, B, pts, zs = _chain_inputs(C, N, seed=N)
    packed = form == "cn2_fwd"
    flat, tB, tpts, tzs = _port_inputs(fc, B, pts, zs, packed)
    if form == "cn_mlp_fwd":  # fed the port's PE of kernel 1 (scale 2)
        _, _, emb1, emb2 = tff._embed(tpts, tB, 0.5)
        emb = (emb1.contiguous(), emb2.contiguous())
        got = tile_chain(form, flat, tzs, emb=emb)
        want = tff.codenerf_mlp_fwd_plain(flat, *emb, tzs)
        assert got.shape == (C, N, 4)
        _close(got, want)
        return
    got = tile_chain(form, flat, tzs, tB, tpts, 0.5)
    if packed:
        want = tff.codenerf_packed_fwd_plain(flat, tB, tpts, tzs, 0.5)
        assert got[0].shape == (N, C) and got[1].shape == (N, 3 * C)
        for x, y in zip(got, want):
            _close(x, y)
    else:
        want = tff.codenerf_fwd_plain(flat, tB, tpts, tzs, 0.5)
        assert got.shape == (C, N, 4)
        _close(got, want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("C,N", CHAIN_SHAPES)
def test_tile_chain_matches_the_jax_kernel(form, C, N):
    """Against the Pallas kernel of each form in interpret mode: kernel 1's
    `_codenerf_fwd_kernel` (:124) and kernel 5's `_cn2_fwd_kernel` (:773,
    tile 32: a ragged last tile at both N); kernel 7's `mlp_kernel`
    (exp_kernel2.py:73) is a closure of the script's `main`, so its form
    is held against the chain that kernel runs, `_codenerf_chain` (:81)
    over the stacked weights of `_cn_param_arrays` (:245), fed the same
    embedding (as tests/test_torch_packed_field.py holds its plain
    version)."""
    import jax
    import jax.numpy as jnp

    from catnerf_tpu.experimental import fused_field as jff

    fc, B, pts, zs = _chain_inputs(C, N, seed=N)
    packed = form == "cn2_fwd"
    flat, tB, tpts, tzs = _port_inputs(fc, B, pts, zs, packed)
    if form == "cn_mlp_fwd":
        emb1, emb2 = _mlp_embedding(B, pts)
        Wl, bl = jff._cn_param_arrays(fc)

        def one(e1, e2, z0, z1, z2, z3, Ws, bs):
            sg, col, _ = jff._codenerf_chain(
                e1, e2, z0, z1, z2, z3, dict(zip(jff._CN_WKEYS, Ws)),
                dict(zip(jff._CN_WKEYS, bs)))
            return jnp.concatenate([sg, col], axis=-1)

        want = jax.vmap(one)(jnp.asarray(emb1), jnp.asarray(emb2),
                             *(jnp.asarray(z) for z in zs), Wl, bl)
        got = tile_chain(form, flat, tzs,
                         emb=(torch.tensor(emb1), torch.tensor(emb2)))
        _close(got, want)
        return
    got = tile_chain(form, flat, tzs, tB, tpts, 0.5)
    if packed:
        s, r = jff.codenerf_packed_apply(
            fc, {"B": jnp.asarray(B)}, jnp.asarray(_point_major(pts)),
            *(jnp.asarray(_point_major(z)) for z in zs), scale=2.0, tile=32,
            interpret=True)
        _close(got[0], s)
        _close(got[1], np.asarray(r).reshape(N, 3 * C))
    else:
        s, r = jff.codenerf_fused_apply(
            fc, {"B": jnp.asarray(B)}, jnp.asarray(pts),
            *(jnp.asarray(z) for z in zs), scale=2.0, interpret=True)
        _close(got[..., 0], s)
        _close(got[..., 1:], r)


# --- kernel 7's load of its embedding (csrc/codenerf_fwd.cu load_emb) ---

EMB_LOAD_ROWS = (1, 77, 130)


def emb_case(N, seed, device="cpu"):
    """Kernel 7's embedding rows: emb1 [N, 87], emb2 [N, 42], uniform in
    [-1, 1] (float32, on `device`)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.uniform(-1.0, 1.0, size=(N, k)).astype(
        np.float32), device=device) for k in (87, 42))


@pytest.mark.parametrize("N", EMB_LOAD_ROWS)
def test_emb_load_plain_is_each_blocks_k_major_image(N):
    emb1, emb2 = emb_case(N, seed=N)
    before = dict(tff.LAUNCHES)
    got = tff.cn_emb_load(emb1, emb2)
    assert tff.LAUNCHES == before  # the CPU takes the plain version
    rows = tff.EMB_BLOCK_ROWS
    nb = -(-N // rows)
    for x, y in zip((emb1, emb2), got):
        k = x.shape[1]
        assert y.shape == (nb, k, rows)
        for blk in range(nb):
            part = x[blk * rows:(blk + 1) * rows].numpy()
            np.testing.assert_array_equal(y[blk, :, :len(part)].numpy(),
                                          part.T)
            assert not y[blk, :, len(part):].any()  # rows past N zero


def test_emb_load_rejects_emb2_padded_for_the_tpu():
    """exp_kernel2.py pads emb2 to 48 columns for the TPU's lanes; the
    kernel reads 42 a row and takes nothing else."""
    emb1, emb2 = emb_case(4, seed=0)
    padded = torch.nn.functional.pad(emb2, (0, 6))
    with pytest.raises(ValueError, match=r"emb2: shape \(4, 48\)"):
        tff.cn_emb_load_cuda(emb1, padded)


# --- the chain kernel's sine (csrc/cn_tile.cuh sin_f32) ---

_PI_BITS = 400
_SRC = (build.CSRC / "cn_tile.cuh").read_text()  # the tile body


def _pi_scaled() -> int:
    """floor(pi 2^_PI_BITS), by Machin's formula in integers."""
    guard = _PI_BITS + 32

    def atan_inv(x):  # atan(1/x) 2^guard
        total, term, n, sign = 0, (1 << guard) // x, 1, 1
        while term:
            total += sign * (term // n)
            term //= x * x
            n += 2
            sign = -sign
        return total

    return (16 * atan_inv(5) - 4 * atan_inv(239)) >> 32


def _two_over_pi_table():
    body = re.search(r"kTwoOverPi\[8\] = \{([^}]*)\}", _SRC).group(1)
    return [int(w.strip().rstrip("u"), 0) for w in body.split(",")]


def test_sine_table_holds_the_bits_of_two_over_pi():
    table = _two_over_pi_table()
    assert len(table) == 8 and table[0] == 0
    # the top 224 bits of 2/pi's fraction
    top = (2 << (_PI_BITS + 224)) // _pi_scaled()
    want = [(top >> (224 - 32 * (i + 1))) & 0xFFFFFFFF for i in range(7)]
    assert table[1:] == want


def test_sine_cody_waite_constants_sum_to_half_pi():
    """c1 = f32(pi/2) (the first FMA exact) and c1 + c2 + c3 within 2^-72
    of pi/2; 2/pi rounded to float32."""
    lits = [float.fromhex(x) for x in re.findall(
        r"fmaf\(-j, (-?0x[0-9a-f.]+p[-+]\d+)f", _SRC)]
    assert len(lits) == 3
    half_pi = Fraction(_pi_scaled(), 2 << _PI_BITS)
    assert lits[0] == float(np.float32(float(half_pi)))
    assert all(float(np.float32(c)) == c for c in lits)
    assert abs(sum(Fraction(c) for c in lits) - half_pi) < Fraction(1, 2**72)
    two_over_pi = re.search(r"rintf\(x \* (0x[0-9a-f.]+p-1)f\)", _SRC)
    assert float.fromhex(two_over_pi.group(1)) == float(
        np.float32(float(1 / half_pi)))


def _large_reduction(x: np.float32):
    """sin_f32's Payne-Hanek branch for |x| > 105615, word for word:
    (quadrant mod 4, the signed fraction as an int64 over 2^64)."""
    table = _two_over_pi_table()
    ix = int(np.abs(x).view(np.uint32))
    m = (ix & 0x7FFFFF) | 0x800000
    pos = (ix >> 23) - 127 + 7
    w, sh = pos >> 5, pos & 31
    funnel = lambda lo, hi: ((((hi << 32) | lo) << sh) >> 32) & 0xFFFFFFFF
    w2 = funnel(table[w + 1], table[w])
    w1 = funnel(table[w + 2], table[w + 1])
    w0 = funnel(table[w + 3], table[w + 2])
    p0 = m * w0
    p1 = m * w1 + (p0 >> 32)
    p2 = m * w2 + (p1 >> 32)
    hi = p2 & 0xFFFFFFFF
    f = (((hi & 0x3FFFFFFF) << 34) | ((p1 & 0xFFFFFFFF) << 2)
         | ((p0 & 0xFFFFFFFF) >> 30))
    q = ((hi >> 30) + (f >> 63)) & 3
    return q, f - (1 << 64) if f >> 63 else f


@pytest.mark.parametrize("exponent", [16, 17, 40, 64, 65, 96, 97, 127])
def test_sine_large_argument_reduction_is_exact(exponent):
    """|x| 2/pi = 4n + q + frac, |frac| <= 1/2: the mirror's quadrant and
    fraction against the exact ones, for float32 arguments of one binary
    exponent (those past 105,615, 2^16.7, take this branch)."""
    rng = np.random.default_rng(exponent)
    two_over_pi = Fraction(2 << _PI_BITS, _pi_scaled())
    sig = rng.integers(0, 1 << 23, size=200)
    xs = ((np.uint32(exponent + 127) << np.uint32(23)) | sig.astype(
        np.uint32)).view(np.float32)
    for x in xs[np.abs(xs) > 105615]:
        q, f = _large_reduction(x)
        t = Fraction(float(x)) * two_over_pi
        k = round(t)
        assert q == k % 4, float(x)
        assert abs(Fraction(f, 1 << 64) - (t - k)) < Fraction(1, 2**60)
