"""bf16 activation storage (`Config.bf16_activations`, the JAX package's
`act_dtype`) in the port's XLA-path modules against the JAX package's, run
eagerly on the CPU: `embedding.apply`, `codenerf.project_codes`,
`train/step.py::gather_injections`, `codenerf.apply_with_injections` and
`occupancy.apply`, forward and gradients, on the same inputs
(JAX-initialised weights, numpy draws).

bf16 is a storage dtype only: each product upcasts its stored operand and
runs in float32 on both sides. Where a float32 result lies within float32
summation noise of a bf16 rounding boundary, the two sides store values one
bf16 ulp apart (a "flip"). The tests count the flips of every stored
tensor and bound their share (FLIP_SHARE), each flip one ulp beyond the
float32 tolerance:

- layer by layer, each layer fed the same (the JAX side's) bf16 input, so
  that a layer's own flips are counted apart from those it inherits;
- the whole module: its float32 outputs within FWD_TOL plus twice the
  first-order effect of the layers' own flips, the port's Jacobian of each
  output row times each flip (rows are independent in these fields);
- gradients: within the float32 tolerance plus one bf16 ulp of the leaf's
  largest entry (GRAD_ULP): a flipped stored value or cotangent moves each
  of its terms by at most one ulp, 2^-7 relative, and the flips are a
  share below FLIP_SHARE of the terms of every sum.

Observed on these inputs (each test prints its counts with `-s`): the
embeddings and the injection tables 0 flips; the injection tables'
gradients 0 of 1,024; apply_with_injections 1 own flip in 4,608 values
of two stored tensors (shipped architecture), 0 in the wider one;
occupancy 0 at hidden 128 and 64, 1-3 of 3,840 a layer at hidden 32. The
bf16 embedding gradients (sums that cancel) differ in 0.01-0.9% of their
entries, within GRAD_ULP of their largest.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_tpu.models import codenerf as jcodenerf
from catnerf_tpu.models import embedding as jembedding
from catnerf_tpu.models import occupancy as joccupancy
from catnerf_tpu.train import step as jstep
from catnerf_torch import convert
from catnerf_torch.models import codenerf, embedding, occupancy
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.layers import linear, linear_relu
from catnerf_torch.models.occupancy import OccupancyMap
from catnerf_torch.train import step as tstep

torch.set_num_threads(1)

BF16 = torch.bfloat16
FWD_TOL = 1e-5          # the float32 modules' (test_torch_xla_path.py)
LAYER_GRAD_TOL = 2e-4   # the float32 weight gradients' (same file)
EMB_GRAD_TOL = 1e-4     # the float32 embedding gradients' (same file)
ULP = 2.0 ** -7         # one bf16 ulp, relative to the value's binade
FLIP_SHARE = 0.01       # at most 1% of a stored tensor's elements flip
GRAD_ULP = ULP          # gradients: one ulp of the leaf's largest entry


def _np32(x) -> np.ndarray:
    """A JAX or torch tensor (any float dtype) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(x32: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value: 2^-7 of its binade."""
    mag = np.maximum(np.abs(x32), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def count_flips(name: str, got, want, max_share: float = FLIP_SHARE,
                max_ulps: float | None = 1.0) -> int:
    """Elements of two bf16 tensors that differ (flips): at most max_share
    of them, each by at most max_ulps ulps beyond the float32 tolerance
    FWD_TOL (a result that cancels to near zero carries float32 noise of
    its terms' size, beyond one ulp of its own); max_ulps None: no bound
    on each. Returns their number."""
    g, w = _np32(got), _np32(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    err = np.abs(g - w)
    lim = _ulp(np.maximum(np.abs(g), np.abs(w))) + FWD_TOL * (1 + np.abs(w))
    n = int((err > 0).sum())
    worst = float((err / lim).max(initial=0.0))
    print(f"{name}: {n} of {g.size} flipped, worst {worst:.2f} ulp")
    assert max_ulps is None or worst <= max_ulps, (
        f"{name}: a stored value {worst:.2f} x one ulp beyond FWD_TOL off")
    assert n <= max_share * g.size, (
        f"{name}: {n} of {g.size} stored values flipped (> {max_share:%})")
    return n


def grads_close(name: str, got, want, tol: float) -> float:
    """A gradient leaf within tol (absolute plus relative) plus GRAD_ULP of
    its largest entry. Returns its largest difference over its largest
    entry."""
    g, w = _np32(got), _np32(want)
    scale = np.abs(w).max(initial=0.0)
    lim = tol + tol * np.abs(w) + GRAD_ULP * scale
    worst = float((np.abs(g - w) / lim).max(initial=0.0))
    assert worst <= 1.0, f"{name}: {worst:.2f} x its bound"
    return float(np.abs(g - w).max(initial=0.0) / max(scale, 1e-30))


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _unstack(tree, c):
    return jax.tree.map(lambda x: x[c], tree)


class _Spy:
    """Records (args, result) of each call of `module.name`."""

    def __init__(self, mp, module, name):
        self.calls = []
        fn = getattr(module, name)

        def spy(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        mp.setattr(module, name, spy)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "stacked"])
def test_embedding_bf16_matches_jax(lead):
    """The embedding computed in float32 and stored once as bf16 (ref:
    embedding.py:153): flips of the stored embedding; the gradients of
    the basis and the points equal the float32 path's, since both sides
    round the cotangent alike."""
    rng = np.random.default_rng(2)
    B = (np.broadcast_to(jembedding.ICOSAHEDRON_DIRS, lead + (21, 3))
         + 0.05 * rng.normal(size=lead + (21, 3))).astype(np.float32)
    x = rng.normal(size=lead + (40, 5, 3)).astype(np.float32)
    w = rng.normal(size=lead + (40, 5, 129)).astype(np.float32)

    def f(B, x):
        one = lambda b, p: jembedding.apply({"B": b}, p, scale=2.0,
                                            act_dtype=jnp.bfloat16)
        emb = jax.vmap(one)(B, x) if lead else one(B, x)
        return jnp.sum(emb.astype(jnp.float32) * w), emb

    (_, want), (gB, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(B, x)
    pe = UniDirsEmbed(torch.tensor(B))
    xt = torch.tensor(x, requires_grad=True)
    got = embedding.apply(pe, xt, scale=2.0, act_dtype=BF16)
    (got.float() * torch.tensor(w)).sum().backward()
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    n = count_flips("embedding", got, want)
    print(f"embedding {lead}: {n} of {got.numel()} stored values flipped")
    np.testing.assert_allclose(_np32(pe.B.grad), _np32(gB), rtol=EMB_GRAD_TOL,
                               atol=EMB_GRAD_TOL)
    np.testing.assert_allclose(_np32(xt.grad), _np32(gx), rtol=EMB_GRAD_TOL,
                               atol=EMB_GRAD_TOL)


def _codenerf_params(C, seed, **kw):
    fc = _stack([jcodenerf.init_params(k, **kw)
                 for k in jax.random.split(jax.random.PRNGKey(seed), C)])
    return fc, CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))


def test_project_codes_bf16_matches_jax():
    """The injections projected in float32 and stored as bf16 (ref:
    codenerf.py:78-79): flips of both injection tables; the gradients of
    the latent layers and the codes within the float32 bound."""
    C, n_obj, L = 3, 5, 16
    rng = np.random.default_rng(6)
    fc, tfc = _codenerf_params(C, 6, latent_dim=L)
    sl = rng.normal(size=(C, n_obj, L)).astype(np.float32)
    tl = rng.normal(size=(C, n_obj, L)).astype(np.float32)
    ws = rng.normal(size=(C, n_obj, 96)).astype(np.float32)
    wt = rng.normal(size=(C, n_obj, 32)).astype(np.float32)

    def loss(fc, sl, tl):
        s, t = jax.vmap(lambda p, a, b: jcodenerf.project_codes(
            p, a, b, act_dtype=jnp.bfloat16))(fc, sl, tl)
        return (jnp.sum(s.astype(jnp.float32) * ws)
                + jnp.sum(t.astype(jnp.float32) * wt)), (s, t)

    (_, (s, t)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(fc, sl, tl)
    tsl = torch.tensor(sl, requires_grad=True)
    ttl = torch.tensor(tl, requires_grad=True)
    ts, tt = codenerf.project_codes(tfc, tsl, ttl, act_dtype=BF16)
    ((ts.float() * torch.tensor(ws)).sum()
     + (tt.float() * torch.tensor(wt)).sum()).backward()
    assert ts.dtype == tt.dtype == BF16
    n = (count_flips("shape injections", ts, s)
         + count_flips("texture injections", tt, t))
    print(f"project_codes: {n} of {ts.numel() + tt.numel()} flipped")
    got = convert.tree_of(tfc, grads=True)
    for key in ("shape_latent_layers", "texture_latent_layers",
                "cat_latent_layer"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, _np32(a), rtol=LAYER_GRAD_TOL, atol=LAYER_GRAD_TOL),
            grads[0][key], got[key])
    for g, tg in zip(grads[1:], (tsl.grad, ttl.grad)):
        np.testing.assert_allclose(_np32(tg), _np32(g), rtol=LAYER_GRAD_TOL,
                                   atol=LAYER_GRAD_TOL)


def test_gather_injections_bf16_matches_jax():
    """The per-ray lookup of bf16 injections (ref: step.py:77-93): the
    values bitwise (one 1.0 a row), the gradient of the tables summed in
    float32 and rounded once on both sides, so it differs only by flips."""
    C, n_obj, R = 2, 4, 300
    rng = np.random.default_rng(7)
    bf = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32)
                                ).astype(jnp.bfloat16)
    inj_s, inj_t = bf(C, n_obj, 96), bf(C, n_obj, 32)
    idx = rng.integers(0, n_obj, size=(C, R)).astype(np.int32)
    ct_s, ct_t = bf(C, R, 96), bf(C, R, 32)
    (s, t), vjp = jax.vjp(
        lambda a, b: jstep._gather_injections(a, b, jnp.asarray(idx)),
        inj_s, inj_t)
    g_s, g_t = vjp((ct_s, ct_t))

    tb = lambda a, grad=False: torch.tensor(_np32(a)).to(BF16).requires_grad_(
        grad)
    tinj_s, tinj_t = tb(inj_s, True), tb(inj_t, True)
    ts, tt = tstep.gather_injections(tinj_s, tinj_t, torch.tensor(idx))
    assert ts.dtype == tt.dtype == BF16
    np.testing.assert_array_equal(_np32(ts), _np32(s))
    np.testing.assert_array_equal(_np32(tt), _np32(t))
    torch.autograd.backward((ts, tt), (tb(ct_s), tb(ct_t)))
    n = (count_flips("shape table gradient", tinj_s.grad, g_s)
         + count_flips("texture table gradient", tinj_t.grad, g_t))
    print(f"gather_injections: {n} of {g_s.size + g_t.size} gradient "
          "values flipped")


def test_injection_add_gradient_sums_samples_in_bf16_like_jax():
    """The gradient of a bf16 injection broadcast over a ray's samples
    ([C, R, 1, w] + [C, R, S, w]) equals the JAX package's bitwise: JAX's
    CPU backend sums the samples in bf16, one at a time in order, which a
    float32 sum rounded once does not reproduce (it differs in about half
    the entries, printed)."""
    C, R, S, W = 2, 50, 10, 32
    rng = np.random.default_rng(10)
    bf = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32)
                                ).astype(jnp.bfloat16)
    y, inj, ct = bf(C, R, S, W), bf(C, R, 1, W), bf(C, R, S, W)
    _, vjp = jax.vjp(lambda a: y + a, inj)
    (want,) = vjp(ct)
    tb = lambda a: torch.tensor(_np32(a)).to(BF16)
    tinj = tb(inj).requires_grad_()
    out = codenerf._inject(tb(y), tinj)
    np.testing.assert_array_equal(_np32(out), _np32(y + inj))
    out.backward(tb(ct))
    np.testing.assert_array_equal(_np32(tinj.grad), _np32(want))
    once = tb(ct).float().sum(-2, keepdim=True).to(BF16)
    n = int((once != tinj.grad).sum())
    print(f"a float32 sum rounded once differs in {n} of {once.numel()}")
    assert n > 0


def _first_order_bound(outs, stored, own_flips):
    """Per output element: twice the first-order effect of the layers' own
    flips, sum over stored tensors t and their elements i of
    |d out / d h_t,i| * |flip_t,i|, from the port's own Jacobian (each
    output row depends only on its own row of every stored tensor, so the
    gradient of an output's sum gives each row's derivatives)."""
    bounds = []
    for out in outs:
        lim = torch.zeros_like(out)
        for ch in range(out.shape[-1]):
            grads = torch.autograd.grad(out[..., ch].sum(), stored,
                                        retain_graph=True, allow_unused=True)
            lim[..., ch] = sum(
                (g.float().abs() * f).sum(-1)
                for g, f in zip(grads, own_flips) if g is not None)
        bounds.append(2.0 * lim)
    return bounds


def _hold_outputs(name, outs, want, bounds):
    for i, (o, w, b) in enumerate(zip(outs, want, bounds)):
        err = np.abs(_np32(o) - _np32(w))
        lim = FWD_TOL + FWD_TOL * np.abs(_np32(w)) + _np32(b)
        worst = float((err / lim).max())
        assert worst <= 1.0, f"{name} output {i}: {worst:.2f} x its bound"


# (name, codenerf.init_params kwargs, do_cat): the shipped architecture and
# one the fused kernels do not take
CN_ARCHS = [
    ("shipped", dict(), True),
    ("w64_shape3_tex2", dict(W=64, shape_blocks=3, texture_blocks=2), True),
]


@pytest.fixture(scope="module", params=CN_ARCHS, ids=lambda a: a[0])
def cn_bf16(request):
    """C=2 CodeNeRFs on the step's shapes: a bf16 embedding [C, R=12,
    Bt=6, 129] and bf16 injections [C, R, 1, w], through JAX's
    `apply_with_injections` per category (each stored tensor recorded) and
    the port's stacked one, both in bf16; and the gradients of
    sum(sin(sigma)) + sum(rgb^2) w.r.t. every parameter, the embedding and
    the injections."""
    _, kw, do_cat = request.param
    C, R, Bt = 2, 12, 6
    rng = np.random.default_rng(8)
    fc, tfc = _codenerf_params(C, 8, latent_dim=8, **kw)
    W = fc["shape_layers"][0]["w"].shape[-1]
    n_s = len(fc["shape_layers"]) + do_cat
    n_t = len(fc["texture_layers"])
    bf = lambda a: jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
    emb = bf(rng.uniform(-1, 1, size=(C, R, Bt, 129)))
    inj_s = bf(np.maximum(rng.normal(size=(C, R, 1, n_s * W)), 0))
    inj_t = bf(np.maximum(rng.normal(size=(C, R, 1, n_t * W)), 0))
    call = lambda p, e, a, b: jcodenerf.apply_with_injections(
        p, e, a, b, do_cat=do_cat, act_dtype=jnp.bfloat16)

    # the JAX side per category, eagerly, each stored tensor recorded: the
    # ReLU layers' outputs and encoding_shape's (the first direct `linear`)
    jrec = []
    with pytest.MonkeyPatch.context() as mp:
        lr = _Spy(mp, jcodenerf, "linear_relu")
        lin = _Spy(mp, jcodenerf, "linear")
        sr = [call(_unstack(fc, c), emb[c], inj_s[c], inj_t[c])
              for c in range(C)]
        per_c = len(lr.calls) // C
        for c in range(C):
            calls = lr.calls[c * per_c:(c + 1) * per_c]
            jrec.append([(a[1], out.astype(jnp.bfloat16))
                         for a, _, out in calls]
                        + [(lin.calls[c * 4][0][1],
                            lin.calls[c * 4][2].astype(jnp.bfloat16))])
    want = tuple(jnp.stack([o[i] for o in sr]) for i in range(2))
    jstored = [(jnp.stack([jrec[c][k][0] for c in range(C)]),
                jnp.stack([jrec[c][k][1] for c in range(C)]))
               for k in range(len(jrec[0]))]

    def loss(fc, emb, a, b):
        s, r = jax.vmap(call)(fc, emb, a, b)
        return jnp.sum(jnp.sin(s)) + jnp.sum(r * r)

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(fc, emb, inj_s, inj_t)

    # the port, each stored tensor recorded and kept for its Jacobian
    tb = lambda a: torch.tensor(_np32(a)).to(BF16).requires_grad_()
    temb, tinj_s, tinj_t = tb(emb), tb(inj_s), tb(inj_t)
    with pytest.MonkeyPatch.context() as mp:
        lr = _Spy(mp, codenerf, "linear_relu")
        st = _Spy(mp, codenerf, "store")
        outs = codenerf.apply_with_injections(
            tfc, temb, tinj_s, tinj_t, do_cat=do_cat, act_dtype=BF16)
    # each layer again on the JAX side's input: the ReLU layers, then
    # encoding_shape, stored after sigma
    own = []
    with torch.no_grad():
        for (args, _, _), (jx, _) in zip(lr.calls, jstored):
            own.append(linear_relu(args[0], torch.tensor(_np32(jx)).to(BF16),
                                   BF16))
        own.append(linear(tfc.encoding_shape,
                          torch.tensor(_np32(jstored[-1][0])).to(BF16)
                          ).to(BF16))
    return dict(
        do_cat=do_cat, tfc=tfc, want=want, jgrads=jgrads, jstored=jstored,
        outs=outs, stored=[out for _, _, out in lr.calls + st.calls],
        own=own, emb=temb, inj=(tinj_s, tinj_t))


def test_apply_with_injections_bf16_layers_match_jax(cn_bf16):
    """Each stored tensor's own flips: each ReLU layer and encoding_shape
    fed the JAX side's bf16 input."""
    jstored = cn_bf16["jstored"]
    assert len(cn_bf16["stored"]) == len(jstored) == len(cn_bf16["own"])
    counts = [count_flips(f"stored tensor {k}", got, jout)
              for k, (got, (_, jout)) in enumerate(zip(cn_bf16["own"],
                                                      jstored))]
    print(f"apply_with_injections, own flips by layer: {counts}")


def test_apply_with_injections_bf16_matches_jax(cn_bf16):
    """The whole chain: every stored tensor at a bounded share of flips
    (inherited ones included), and sigma and rgb within FWD_TOL plus
    twice the first-order effect of the layers' own flips."""
    stored, jstored = cn_bf16["stored"], cn_bf16["jstored"]
    counts = [count_flips(f"stored tensor {k}", t, j, max_ulps=None)
              for k, (t, (_, j)) in enumerate(zip(stored, jstored))]
    print(f"apply_with_injections, flips by stored tensor: {counts}")
    own = [torch.tensor(np.abs(_np32(got) - _np32(jout)))
           for got, (_, jout) in zip(cn_bf16["own"], jstored)]
    outs = cn_bf16["outs"]
    bounds = _first_order_bound(outs, stored, own)
    _hold_outputs("apply_with_injections", outs, cn_bf16["want"], bounds)


def test_apply_with_injections_bf16_grads_match_jax(cn_bf16):
    """Every parameter, the embedding and both injections."""
    tfc = cn_bf16["tfc"]
    temb, (tinj_s, tinj_t) = cn_bf16["emb"], cn_bf16["inj"]
    for p in (temb, tinj_s, tinj_t, *tfc.parameters()):
        p.grad = None
    s, r = codenerf.apply_with_injections(
        tfc, temb, tinj_s, tinj_t, do_cat=cn_bf16["do_cat"], act_dtype=BF16)
    (torch.sin(s).sum() + (r * r).sum()).backward()
    gfc, gemb, gs, gt = cn_bf16["jgrads"]
    jax.tree.map(lambda a, b: grads_close("cat_fc", b, a, LAYER_GRAD_TOL),
                 gfc, convert.tree_of(tfc, grads=True))
    assert temb.grad.dtype == BF16
    grads_close("embedding gradient", temb.grad, gemb, LAYER_GRAD_TOL)
    grads_close("shape injections", tinj_s.grad, gs, LAYER_GRAD_TOL)
    grads_close("texture injections", tinj_t.grad, gt, LAYER_GRAD_TOL)


OC_ARCHS = [
    ("hidden128", dict(hidden_size=128), dict()),
    ("hidden64_blocks2", dict(hidden_size=64, hidden_layers_block=2), dict()),
    ("hidden32_no_cat", dict(hidden_size=32), dict(do_cat=False)),
]


@pytest.mark.parametrize("arch", OC_ARCHS, ids=lambda a: a[0])
def test_occupancy_bf16_matches_jax(arch):
    """The background field in bf16 (ref: occupancy.py:53-73): each ReLU
    layer's own flips (fed the JAX side's input), every stored tensor, alpha
    and colour within FWD_TOL plus twice the first-order effect of the own
    flips, and every gradient."""
    _, init_kw, kw = arch
    rng = np.random.default_rng(9)
    fc = joccupancy.init_params(jax.random.PRNGKey(9), **init_kw)
    emb = jnp.asarray(rng.uniform(-1, 1, size=(30, 4, 129)).astype(
        np.float32)).astype(jnp.bfloat16)
    call = lambda p, e: joccupancy.apply(p, e, act_dtype=jnp.bfloat16, **kw)
    with pytest.MonkeyPatch.context() as mp:
        lr = _Spy(mp, joccupancy, "linear_relu")
        a, c = call(fc, emb)
        jstored = [(args[1], out.astype(jnp.bfloat16))
                   for args, _, out in lr.calls]

    def loss(fc, emb):
        a, c = call(fc, emb)
        return jnp.sum(jnp.tanh(a)) + jnp.sum(c * c)

    gfc, gemb = jax.grad(loss, argnums=(0, 1))(fc, emb)

    tfc = OccupancyMap(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    temb = torch.tensor(_np32(emb)).to(BF16).requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        lr = _Spy(mp, occupancy, "linear_relu")
        ta, tc = occupancy.apply(tfc, temb, act_dtype=BF16, **kw)
    assert len(lr.calls) == len(jstored)
    stored = [out for _, _, out in lr.calls]
    own, n_own = [], []
    for (args, _, _), (jx, jout) in zip(lr.calls, jstored):
        with torch.no_grad():
            got = linear_relu(args[0], torch.tensor(_np32(jx)).to(BF16), BF16)
        n_own.append(count_flips("own", got, jout))
        own.append(torch.tensor(np.abs(_np32(got) - _np32(jout))))
    n_all = [count_flips("stored", t, j, max_ulps=None)
             for t, (_, j) in zip(stored, jstored)]
    print(f"occupancy {arch[0]}: own flips {n_own}, all flips {n_all}")
    bounds = _first_order_bound((ta, tc), stored, own)
    _hold_outputs("occupancy", (ta, tc), (a, c), bounds)

    (torch.tanh(ta).sum() + (tc * tc).sum()).backward()
    jax.tree.map(lambda g, t: grads_close("bg_fc", t, g, LAYER_GRAD_TOL),
                 gfc, convert.tree_of(tfc, grads=True))
    grads_close("embedding gradient", temb.grad, gemb, LAYER_GRAD_TOL)
