"""The port's fused field functions (catnerf_torch/kernels/fused_field.py)
against the JAX package's Pallas kernels.

On the CPU the port takes its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_fused_field.py does. Same
inputs (JAX-initialised weights, numpy draws), forward within 1e-5 and
every gradient within 2e-4. The CUDA kernels themselves are held against
the plain version on the card by tests/test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_tpu.experimental import fused_field as jff
from catnerf_tpu.models import codenerf, embedding, occupancy
from catnerf_torch import convert
from catnerf_torch.kernels import fused_field as tff
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
CN_LAYERS = ("encoding_xyz", "shape_layers", "cat_layer", "encoding_shape",
             "sigma", "encoding_viewdir", "texture_layers", "rgb_0", "rgb_1")
OC_LAYERS = ("in_layer", "mid1", "cat_layer", "mid2", "out_alpha",
             "color_linear", "out_color")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def cn_case():
    """C=3 categories x N=100 points; JAX forward and gradients of
    sum(sin(sigma)) + sum(rgb^2), as test_fused_field.py:80-106."""
    C, N, L = 3, 100, 64
    rng = np.random.default_rng(0)
    fc = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        codenerf.init_params(k, latent_dim=L)
        for k in jax.random.split(jax.random.PRNGKey(0), C)])
    B = (np.stack([embedding.ICOSAHEDRON_DIRS] * C)
         + 0.05 * rng.normal(size=(C, 21, 3))).astype(np.float32)
    pts = rng.normal(size=(C, N, 3)).astype(np.float32)
    zs = [np.maximum(rng.normal(size=(C, N, 32)), 0).astype(np.float32)
          for _ in range(4)]

    def loss(fc, B, pts, zs):
        s, r = jff.codenerf_fused_apply(fc, {"B": B}, pts, *zs, scale=2.0,
                                        interpret=True)
        return jnp.sum(jnp.sin(s)) + jnp.sum(r * r), (s, r)

    (_, (s, r)), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        fc, jnp.asarray(B), jnp.asarray(pts), [jnp.asarray(z) for z in zs])

    tfc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    tpe = UniDirsEmbed(torch.tensor(B))
    tpts = torch.tensor(pts, requires_grad=True)
    tzs = [torch.tensor(z, requires_grad=True) for z in zs]
    ts, tr = tff.codenerf_fused_apply(tfc, tpe, tpts, *tzs, scale=2.0)
    (torch.sin(ts).sum() + (tr * tr).sum()).backward()
    return dict(jax=(s, r, g), torch=(ts, tr, tfc, tpe, tpts, tzs),
                inputs=(fc, B, pts, zs))


def test_codenerf_forward_matches_jax(cn_case):
    s, r, _ = cn_case["jax"]
    ts, tr = cn_case["torch"][:2]
    _close(ts.detach(), s, FWD_TOL)
    _close(tr.detach(), r, FWD_TOL)


@pytest.mark.parametrize("layer", CN_LAYERS)
def test_codenerf_layer_grads_match_jax(cn_case, layer):
    g = cn_case["jax"][2][0][layer]
    tg = convert.tree_of(cn_case["torch"][2], grads=True)[layer]
    jax.tree.map(lambda a, b: _close(b, a, GRAD_TOL), g, tg)


def test_codenerf_latent_layers_get_no_kernel_grads(cn_case):
    """The latent layers' gradients flow through the injections, outside
    the kernel (ref: fused_field.py:261-264)."""
    tfc = cn_case["torch"][2]
    for m in [tfc.cat_latent_layer, *tfc.shape_latent_layers,
              *tfc.texture_latent_layers]:
        assert m.w.grad is None and m.b.grad is None


@pytest.mark.parametrize("arg", ["B", "pts", "zs0", "zc", "zs1", "zt0"])
def test_codenerf_input_grads_match_jax(cn_case, arg):
    g = cn_case["jax"][2]
    _, _, _, tpe, tpts, tzs = cn_case["torch"]
    want, got = {
        "B": (g[1], tpe.B.grad), "pts": (g[2], tpts.grad),
        **{k: (g[3][i], tzs[i].grad)
           for i, k in enumerate(("zs0", "zc", "zs1", "zt0"))},
    }[arg]
    _close(got, want, GRAD_TOL)


@pytest.fixture(scope="module")
def oc_case():
    """The background OccupancyMap at N=77 points (test_fused_field.py:109)."""
    rng = np.random.default_rng(1)
    fc = occupancy.init_params(jax.random.PRNGKey(2), hidden_size=128)
    B = (embedding.ICOSAHEDRON_DIRS
         + 0.05 * rng.normal(size=(21, 3))).astype(np.float32)
    pts = (rng.normal(size=(77, 3)) * 2.0).astype(np.float32)

    def loss(fc, B, pts):
        a, c = jff.occupancy_fused_apply(fc, {"B": B}, pts, scale=5.0,
                                         interpret=True)
        return jnp.sum(jnp.tanh(a)) + jnp.sum(c), (a, c)

    (_, (a, c)), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                        has_aux=True)(
        fc, jnp.asarray(B), jnp.asarray(pts))
    tfc = OccupancyMap(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    tpe = UniDirsEmbed(torch.tensor(B))
    tpts = torch.tensor(pts, requires_grad=True)
    ta, tc = tff.occupancy_fused_apply(tfc, tpe, tpts, scale=5.0)
    (torch.tanh(ta).sum() + tc.sum()).backward()
    return dict(jax=(a, c, g), torch=(ta, tc, tfc, tpe, tpts))


def test_occupancy_forward_matches_jax(oc_case):
    a, c, _ = oc_case["jax"]
    ta, tc = oc_case["torch"][:2]
    _close(ta.detach(), a, FWD_TOL)
    _close(tc.detach(), c, FWD_TOL)


@pytest.mark.parametrize("layer", OC_LAYERS)
def test_occupancy_layer_grads_match_jax(oc_case, layer):
    g = oc_case["jax"][2][0][layer]
    tg = convert.tree_of(oc_case["torch"][2], grads=True)[layer]
    jax.tree.map(lambda a, b: _close(b, a, GRAD_TOL), g, tg)


def test_occupancy_input_grads_match_jax(oc_case):
    g = oc_case["jax"][2]
    tpe, tpts = oc_case["torch"][3:]
    _close(tpe.B.grad, g[1], GRAD_TOL)
    _close(tpts.grad, g[2], GRAD_TOL)


#: widths of the background other than the shipped 128: the instantiated
#: 32, 64 and 256, 100, which the kernels run zero-padded to 128, and 300,
#: 512 and 600 past the instantiations (at 320, 512 and 608)
WIDTHS = (32, 64, 100, 256, 300, 512, 600)
RELU_TIE = 1e-5


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda h: f"hidden{h}")
def oc_width_case(request):
    """The background at another width, N=77 points, one cotangent: the
    JAX kernel's forward and vjp in interpret mode, and the port's inputs,
    every point with a ReLU pre-activation within RELU_TIE of zero shifted
    first (ROADMAP.md's rule for a float32 backward)."""
    hidden = request.param
    rng = np.random.default_rng(10 + hidden)
    fc = occupancy.init_params(jax.random.PRNGKey(hidden), hidden_size=hidden)
    B = (embedding.ICOSAHEDRON_DIRS
         + 0.05 * rng.normal(size=(21, 3))).astype(np.float32)
    pts = (rng.normal(size=(77, 3)) * 2.0).astype(np.float32)
    dout = rng.normal(size=(77, 4)).astype(np.float32)
    tfc = OccupancyMap(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    flat = tff.pack(tff._oc_modules(tfc)).detach()
    for _ in range(8):
        tied = tff.occupancy_relu_margin(flat, torch.tensor(B),
                                         torch.tensor(pts), 0.2,
                                         hidden) < RELU_TIE
        if not tied.any():
            break
        pts[tied.numpy()] += 1e-3
    else:
        raise AssertionError("ReLU ties left after 8 shifts")

    def field(fc, B, pts):
        a, c = jff.occupancy_fused_apply(fc, {"B": B}, pts, scale=5.0,
                                         interpret=True)
        return jnp.concatenate([a[:, None], c], -1)

    out, vjp = jax.vjp(field, fc, jnp.asarray(B), jnp.asarray(pts))
    gfc, gB, gpts = vjp(jnp.asarray(dout))
    gmod = OccupancyMap(convert.layers_from_jax(jax.tree.map(np.asarray,
                                                             gfc)))
    return dict(hidden=hidden, out=np.asarray(out),
                grads=(tff.pack(tff._oc_modules(gmod)).detach(),
                       torch.tensor(np.asarray(gB)),
                       torch.tensor(np.asarray(gpts))),
                args=(flat, torch.tensor(B), torch.tensor(pts)),
                dout=torch.tensor(dout))


def test_occupancy_forward_matches_jax_at_any_width(oc_width_case):
    """The port's background at the width read from its weights (plain
    version on the CPU): within 1e-5 of the output's scale."""
    c = oc_width_case
    assert c["args"][0].shape == (tff.n_params(tff.oc_layers(c["hidden"])),)
    out = tff.occupancy_fwd(*c["args"], 0.2, c["hidden"])
    assert out.shape == (77, 4)
    scale = float(np.abs(c["out"]).max())
    assert float(np.abs(out.numpy() - c["out"]).max()) <= FWD_TOL * scale


def test_occupancy_backward_matches_jax_at_any_width(oc_width_case):
    """The JAX kernel's gradients and the port's plain ones, each within
    fused_field.grad_bound of the port's plain backward in float64 (each
    layer's weights and biases a block of the flat gradient)."""
    c = oc_width_case
    h = c["hidden"]
    got = tff.occupancy_bwd(*c["args"], c["dout"], 0.2, h)
    exact = tff.occupancy_bwd_plain(*(x.double() for x in c["args"]),
                                    c["dout"].double(), 0.2, h)
    for i, (theirs, mine, e) in enumerate(zip(c["grads"], got, exact)):
        lim = tff.grad_bound(e, mine, GRAD_TOL,
                             tff.oc_layers(h) if i == 0 else None)
        for x in (theirs, mine):
            assert x.shape == e.shape
            assert bool(((x.double() - e).abs() <= lim).all()), (i, float(
                ((x.double() - e).abs() / lim).max()))


@pytest.mark.parametrize("hidden,width", [(1, 32), (32, 32), (33, 64),
                                          (100, 128), (128, 128),
                                          (129, 256), (256, 256),
                                          (257, 288), (300, 320),
                                          (512, 512), (513, 544),
                                          (600, 608)])
def test_each_width_runs_on_the_next_instantiation(hidden, width):
    """A width runs on the smallest instantiated width at least as wide
    (past the last, on the kernels' run-time width, the next multiple of
    32), its extra units zero: padding and slicing back are exact
    inverses, and the padded field's plain forward is the narrower
    one's."""
    assert tff.oc_kernel_width(hidden) == width
    gen = torch.Generator().manual_seed(hidden)
    flat = tff.pack(tff._oc_modules(OccupancyMap.init(
        gen, hidden_size=hidden))).detach()
    padded = tff.pad_width(flat, hidden, width)
    assert padded.shape == (tff.n_params(tff.oc_layers(width)),)
    assert torch.equal(tff.unpad_width(padded, hidden, width), flat)
    assert int(padded.count_nonzero()) == int(flat.count_nonzero())
    B, pts = torch.randn(21, 3, generator=gen), torch.randn(40, 3,
                                                            generator=gen)
    torch.testing.assert_close(
        tff.occupancy_fwd_plain(padded, B, pts, 0.2, width),
        tff.occupancy_fwd_plain(flat, B, pts, 0.2, hidden),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden", [0])
def test_a_width_past_the_instantiations_raises(hidden):
    with pytest.raises(ValueError, match="positive hidden widths"):
        tff.oc_kernel_width(hidden)


@pytest.mark.parametrize("hidden", [513, 1000, 1024, 1025, 2049, 4096])
def test_every_width_past_the_instantiations_runs_at_a_multiple_of_32(
        hidden):
    """No positive width raises: past the last instantiation a width runs
    on the kernels' run-time width, the next multiple of 32."""
    width = tff.oc_kernel_width(hidden)
    assert width % 32 == 0 and hidden <= width < hidden + 32
    assert width > tff.OC_WIDTHS[-1]


def test_plain_path_on_cpu_launches_no_kernel(cn_case):
    """CPU tensors take the plain version; no kernel launch is counted."""
    before = dict(tff.LAUNCHES)
    fc, B, pts, zs = cn_case["inputs"]
    tfc, tpe = cn_case["torch"][2:4]
    tff.codenerf_fused_apply(tfc, tpe, torch.tensor(pts),
                             *[torch.tensor(z) for z in zs], scale=2.0)
    assert tff.LAUNCHES == before


def test_unsupported_device_raises():
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tff.occupancy_fwd(x, x, x, 0.2)


def test_pack_layout_matches_kernel_constants():
    gen = torch.Generator().manual_seed(0)
    flat = tff.pack(tff._cn_modules(CodeNeRF.init(gen, 2)))
    assert flat.shape == (2, tff.CN_P) and tff.CN_P == 13892
    flat = tff.pack(tff._oc_modules(OccupancyMap.init(gen)))
    assert flat.shape == (tff.OC_P,) and tff.OC_P == 94340
