"""The port's packed-ensemble CodeNeRF (`codenerf_packed_apply`) and its
MLP-only chain (`codenerf_mlp_fwd`) against the JAX package's.

On the CPU the port takes its plain PyTorch versions; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_fused_field.py:190-228
does (C=3 categories x N=100 points, tile 32). Same inputs (JAX-initialised
weights, numpy draws): forward within 1e-5, every gradient within 3e-4
(test_fused_field.py:197-200, :227). The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_tpu.experimental import fused_field as jff
from catnerf_tpu.models import codenerf, embedding
from catnerf_torch import convert
from catnerf_torch.kernels import fused_field as tff
from catnerf_torch.models import embedding as tembedding
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 3e-4
CN_LAYERS = ("encoding_xyz", "shape_layers", "cat_layer", "encoding_shape",
             "sigma", "encoding_viewdir", "texture_layers", "rgb_0", "rgb_1")
Z_NAMES = ("zs0", "zc", "zs1", "zt0")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _inputs(C, N, seed):
    rng = np.random.default_rng(seed)
    fc = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        codenerf.init_params(k, latent_dim=64)
        for k in jax.random.split(jax.random.PRNGKey(seed), C)])
    # the basis at its init, as test_fused_field.py:33: the gradient of a
    # perturbed basis sums terms up to 32*pi times larger than it is, and
    # then carries a float32 rounding error of ~1e-3 on either side
    # (against float64), more than the 3e-4 bound
    B = np.stack([embedding.ICOSAHEDRON_DIRS] * C)
    pts = rng.normal(size=(N, 3 * C)).astype(np.float32)
    zs = [np.maximum(rng.normal(size=(N, 32 * C)), 0).astype(np.float32)
          for _ in range(4)]
    return fc, B, pts, zs


@pytest.fixture(scope="module", params=[100, 77], ids=lambda n: f"N{n}")
def packed_case(request):
    """JAX forward and gradients of sum(sin(sigma)) + sum(rgb^2) through
    the packed kernel (interpret mode), and the port's, on the same inputs;
    N=77 leaves a ragged last tile of 13 rows."""
    C, N = 3, request.param
    fc, B, pts, zs = _inputs(C, N, seed=N)

    def loss(fc, B, pts, zs):
        s, r = jff.codenerf_packed_apply(fc, {"B": B}, pts, *zs, scale=2.0,
                                         tile=32, interpret=True)
        return jnp.sum(jnp.sin(s)) + jnp.sum(r * r), (s, r)

    (_, (s, r)), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        fc, jnp.asarray(B), jnp.asarray(pts), [jnp.asarray(z) for z in zs])

    tfc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    tpe = UniDirsEmbed(torch.tensor(B))
    tpts = torch.tensor(pts, requires_grad=True)
    tzs = [torch.tensor(z, requires_grad=True) for z in zs]
    ts, tr = tff.codenerf_packed_apply(tfc, tpe, tpts, *tzs, scale=2.0,
                                       tile=32)
    (torch.sin(ts).sum() + (tr * tr).sum()).backward()
    return dict(jax=(s, r, g), torch=(ts, tr, tfc, tpe, tpts, tzs))


def test_packed_forward_matches_jax(packed_case):
    s, r, _ = packed_case["jax"]
    ts, tr = packed_case["torch"][:2]
    assert ts.shape == s.shape and tr.shape == r.shape
    _close(ts.detach(), s, FWD_TOL)
    _close(tr.detach(), r, FWD_TOL)


@pytest.mark.parametrize("layer", CN_LAYERS)
def test_packed_layer_grads_match_jax(packed_case, layer):
    g = packed_case["jax"][2][0][layer]
    tg = convert.tree_of(packed_case["torch"][2], grads=True)[layer]
    jax.tree.map(lambda a, b: _close(b, a, GRAD_TOL), g, tg)


@pytest.mark.parametrize("arg", ["B", "pts", *Z_NAMES])
def test_packed_input_grads_match_jax(packed_case, arg):
    g = packed_case["jax"][2]
    _, _, _, tpe, tpts, tzs = packed_case["torch"]
    want, got = {
        "B": (g[1], tpe.B.grad), "pts": (g[2], tpts.grad),
        **{k: (g[3][i], tzs[i].grad) for i, k in enumerate(Z_NAMES)},
    }[arg]
    _close(got, want, GRAD_TOL)


def test_packed_latent_layers_get_no_grads(packed_case):
    """The injections are inputs; the latent layers are not reached."""
    tfc = packed_case["torch"][2]
    for m in [tfc.cat_latent_layer, *tfc.shape_latent_layers,
              *tfc.texture_latent_layers]:
        assert m.w.grad is None and m.b.grad is None


def test_fold_b2_matches_the_jax_slot_layout():
    """B2[k, f*21+d] = B[d,k] * f32(pi 2^f): the first 126 slots of
    _pack_b2 (its last two are zero pad), bitwise."""
    rng = np.random.default_rng(3)
    B = rng.normal(size=(2, 21, 3)).astype(np.float32)
    want = np.asarray(jff._pack_b2(jnp.asarray(B)))
    got = tff.fold_b2(torch.tensor(B)).numpy()
    np.testing.assert_array_equal(got, want[..., :tff.N_SLOTS])
    assert not want[..., tff.N_SLOTS:].any()


def test_unfold_db2_is_the_gradient_of_fold_b2():
    rng = np.random.default_rng(4)
    B = torch.tensor(rng.normal(size=(2, 21, 3)).astype(np.float32),
                     requires_grad=True)
    X = torch.tensor(rng.normal(size=(2, 3, tff.N_SLOTS)).astype(np.float32))
    (tff.fold_b2(B) * X).sum().backward()
    # six products of up to 32*pi |X| summed in another order: float32
    # rounding of sums of order 100
    _close(tff.unfold_db2(X), B.grad, 1e-5)


@pytest.mark.parametrize("tile,ok", [(32, True), (256, True), (384, True),
                                     (0, False), (48, False), (416, False),
                                     (256.0, False)])
def test_packed_tile_is_checked(tile, ok):
    if ok:
        assert tff.check_tile(tile) == tile
    else:
        with pytest.raises(ValueError, match="tile"):
            tff.check_tile(tile)


def test_packed_apply_rejects_a_wrong_lane_count():
    fc = CodeNeRF.init(torch.Generator().manual_seed(0), 2)
    pe = UniDirsEmbed.init((2,))
    z = torch.zeros(5, 64)
    with pytest.raises(ValueError, match=r"\[N, 3C\]"):
        tff.codenerf_packed_apply(fc, pe, torch.zeros(5, 9), z, z, z, z,
                                  scale=2.0)


def test_packed_plain_path_on_cpu_launches_no_kernel():
    fc = CodeNeRF.init(torch.Generator().manual_seed(0), 2)
    pe = UniDirsEmbed.init((2,))
    z = torch.zeros(5, 64)
    before = dict(tff.LAUNCHES)
    s, r = tff.codenerf_packed_apply(fc, pe, torch.zeros(5, 6), z, z, z, z,
                                     scale=2.0)
    (s.sum() + r.sum()).backward()
    assert tff.LAUNCHES == before


def test_mlp_fwd_matches_jax_codenerf_chain_on_the_xla_embedding():
    """Kernel 7's plain version against `_codenerf_chain` (:81) over the
    stacked weights of `_cn_param_arrays` (:245), both fed
    `embedding.apply`'s output (sinpi polynomial), as exp_kernel2.py:96
    does; emb2 unpadded (the script pads it to 48 only for TPU lanes)."""
    C, N = 3, 100
    rng = np.random.default_rng(5)
    fc = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        codenerf.init_params(k, latent_dim=32)
        for k in jax.random.split(jax.random.PRNGKey(5), C)])
    B = (np.stack([embedding.ICOSAHEDRON_DIRS] * C)
         + 0.05 * rng.normal(size=(C, 21, 3))).astype(np.float32)
    pts = rng.normal(size=(C, N, 3)).astype(np.float32)
    zs = [np.maximum(rng.normal(size=(C, N, 32)), 0).astype(np.float32)
          for _ in range(4)]
    emb = jax.vmap(lambda b, p: embedding.apply({"B": b}, p, scale=2.0))(
        jnp.asarray(B), jnp.asarray(pts))
    Wl, bl = jff._cn_param_arrays(fc)

    def one(e, z0, z1, z2, z3, Ws, bs):
        sg, col, _ = jff._codenerf_chain(
            e[:, :87], e[:, 87:], z0, z1, z2, z3,
            dict(zip(jff._CN_WKEYS, Ws)), dict(zip(jff._CN_WKEYS, bs)))
        return jnp.concatenate([sg, col], axis=-1)

    want = jax.vmap(one)(emb, *zs, Wl, bl)

    tfc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    temb = tembedding.apply(UniDirsEmbed(torch.tensor(B)), torch.tensor(pts),
                            scale=2.0)
    np.testing.assert_array_equal(temb.detach().numpy(), np.asarray(emb))
    before = dict(tff.LAUNCHES)
    with torch.no_grad():
        got = tff.codenerf_mlp_fwd(tff.pack(tff._cn_modules(tfc)),
                                   temb[..., :87].contiguous(),
                                   temb[..., 87:].contiguous(),
                                   [torch.tensor(z) for z in zs])
    assert tff.LAUNCHES == before
    assert got.shape == (C, N, 4)
    _close(got, want, FWD_TOL)


def test_kernel_compare_runs_and_checks_on_the_cpu():
    """The comparison path (catnerf_torch.experimental.kernel_compare) at a
    small size with the plain versions: every variant checked against the
    XLA path, one row per timing."""
    from catnerf_torch.experimental import kernel_compare

    lines = []
    rows = kernel_compare.run("cpu", n_cls=2, n_pts=70, tiles=(32, 64), n=1,
                              log=lines.append)
    names = [r["name"] for r in rows]
    assert names == ["xla forward", "packed forward tile=32",
                     "packed forward tile=64", "xla-PE + fused MLP",
                     "xla fwd+bwd", "packed fwd+bwd tile=32",
                     "packed fwd+bwd tile=64"]
    assert len(lines) == len(rows)
    for r in rows:
        assert r["ms"] > 0
        assert (r["max_abs_err"] is None) == r["name"].startswith("xla ")
