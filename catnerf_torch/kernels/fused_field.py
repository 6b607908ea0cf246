"""Fused positional encoding + field MLP, forward and backward, for the
CodeNeRF category ensemble and the OccupancyMap background.

Replaces the Pallas TPU kernels of the JAX package's
`experimental/fused_field.py` (and one of `scripts/exp_kernel2.py`):

  codenerf_fwd         <- _codenerf_fwd_kernel :124 (_make_codenerf_fused)
  codenerf_bwd         <- _codenerf_bwd_kernel :135
  occupancy_fwd        <- _occ_fwd_kernel :435 (via _make_occ_fused)
  occupancy_bwd        <- _occ_bwd_kernel :445
  codenerf_packed_fwd  <- _cn2_fwd_kernel :773 (_make_codenerf_packed)
  codenerf_packed_bwd  <- _cn2_bwd_kernel :786
  codenerf_mlp_fwd     <- exp_kernel2.py mlp_kernel :73 (main.mlp_only)

with CUDA C++ kernels for Hopper, one library per source: `csrc/
codenerf_fwd.cu` (the CodeNeRF forward, the packed forward and the
MLP-only forward, one tiled chain kernel), `csrc/codenerf_bwd.cu` (the
CodeNeRF backward), `csrc/occupancy.cu` (the background forward and
backward) and `csrc/codenerf_packed.cu` (the packed backward). Each public
function keeps the JAX contract
(`codenerf_fused_apply` :384, `occupancy_fused_apply` :631,
`codenerf_packed_apply` :958) and is differentiable through an
`autograd.Function` whose backward is a kernel too; the MLP-only kernel
has no backward, as in the JAX script.

What bounds them on an H100: the operations. Per sample point the
CodeNeRF forward does 13,648 multiply-adds against 55.6 KB of weights that
every point shares, and the background 93,696 against 377 KB. Three
designs:

* the CodeNeRF forward, the packed forward and the MLP-only forward are
  one chain kernel: a block owns one category and 64 rows, stages the
  category's weights in shared memory, computes the PE there (the MLP-only
  kernel loads it, `cn_emb_load`), and runs each layer as a register-tiled
  product out of shared memory (`TILE_LAYERS`), nothing in device memory
  between layers;
* the packed backward runs on the same tile body: a block recomputes
  the packed forward for its category's 64 rows, keeps every activation
  and ReLU mask the backward reads in shared memory, and runs each
  layer's input gradient (`PACKED_DX_PIECES`) and weight gradient
  (`PACKED_BWD_LAYERS`) as register-tiled products there, one partial
  row of weight gradients per block;
* the CodeNeRF backward and the background forward and backward are chains
  of tiled float32 GEMMs (`csrc/gemm_f32.cuh`: a 128 x 32 tile for the
  32-wide CodeNeRF layers, `cn_gemm`, with the category as a batch index,
  and 128 x 128 for the 128-wide background, `oc_gemm`) and row kernels,
  their activations in a workspace the wrapper allocates, their weight
  gradients per-chunk partials.

A last launch adds the partials in a fixed order, so that two runs are
bitwise equal (no atomics).

Numerics: true float32 throughout, the transcendental sin (not the XLA
path's sinpi polynomial), no fast math and no TF32, as the TPU kernels.

Dispatch: a tensor on the CPU takes the plain PyTorch version below; a
tensor on a CUDA device launches the kernel or raises. The plain version
of each kernel also serves as its reference on the card.

Under a CUDA graph (train/graph.py): each wrapper launches on the current
stream and allocates its outputs and workspace with torch.empty, so a
capture records its launch and takes that memory from the graph's pool.
The sources call no cudaMalloc, synchronisation or blocking copy; the
chain kernel's launch sets its dynamic shared memory size
(cudaFuncSetAttribute) at every call, first in the eager warm-up steps.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

# kernel launches by the wrappers below (one per forward or backward call
# that reaches the CUDA kernel; the plain versions never count), and by
# each replay of a CUDA graph that captured them (count_replay)
LAUNCHES = {"codenerf_fwd": 0, "codenerf_bwd": 0,
            "occupancy_fwd": 0, "occupancy_bwd": 0,
            "codenerf_packed_fwd": 0, "codenerf_packed_bwd": 0,
            "codenerf_mlp_fwd": 0, "oc_gemm": 0, "cn_gemm": 0, "cn_tile": 0,
            "cn_sin": 0, "cn_emb": 0, "cn2_dx": 0, "cn2_wgrad": 0,
            "cn_cos": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def launches_captured():
    """Around a CUDA graph's capture, which launches nothing: the wrappers
    count what they enqueue into the graph, and this takes those counts
    back out of LAUNCHES and yields them, filled in on exit, as the
    launches of one replay (`count_replay`)."""
    before = dict(LAUNCHES)
    captured: dict[str, int] = {}
    try:
        yield captured
    finally:
        captured.update({k: n - before[k] for k, n in LAUNCHES.items()
                         if n != before[k]})
        LAUNCHES.update(before)


def count_replay(captured: dict[str, int]) -> None:
    """One replay of a CUDA graph launches the kernels its capture
    enqueued (`launches_captured`)."""
    for k, n in captured.items():
        LAUNCHES[k] += n


_N_FREQS = 6  # 2^0..2^5
N_DIRS = 21
B_SIZE = N_DIRS * 3
N_SLOTS = _N_FREQS * N_DIRS  # 126 folded PE slots of the packed kernel
B2_SIZE = 3 * N_SLOTS
_LOW = 4 * N_DIRS  # 84: the slots of frequencies 2^0..2^3
# the packed kernels' `tile` (the JAX contract's rows per block): a multiple
# of PACKED_ROWS, at most PACKED_MAX_TILE (check_tile)
PACKED_ROWS = 32
PACKED_MAX_TILE = 384
# the rows a block of the tiled packed backward takes, whatever `tile` is
PACKED_BLOCK_ROWS = 64

# (key, fan_in, fan_out) in kernel order; the flat parameter buffer holds
# every weight [in, out] row-major in this order, then every bias.
CN_LAYERS = (("e", 87, 32), ("s0", 32, 32), ("c", 119, 32), ("s1", 32, 32),
             ("en", 32, 32), ("sg", 32, 1), ("vd", 74, 32), ("t0", 32, 32),
             ("r0", 32, 16), ("r1", 16, 3))
OC_LAYERS = (("in", 87, 128), ("m1", 128, 128), ("c", 215, 128),
             ("m2", 128, 128), ("oa", 128, 1), ("cl", 170, 128),
             ("oc", 128, 3))


def n_params(layers) -> int:
    return sum(i * o + o for _, i, o in layers)


CN_P = n_params(CN_LAYERS)  # 13,892
OC_P = n_params(OC_LAYERS)  # 94,340


def _cn_modules(fc):
    """CodeNeRF layers in kernel order (module attribute -> kernel key)."""
    return (fc.encoding_xyz, fc.shape_layers[0], fc.cat_layer,
            fc.shape_layers[1], fc.encoding_shape, fc.sigma,
            fc.encoding_viewdir, fc.texture_layers[0], fc.rgb_0, fc.rgb_1)


def _oc_modules(fc):
    return (fc.in_layer, fc.mid1[0], fc.cat_layer, fc.mid2[0],
            fc.out_alpha, fc.color_linear, fc.out_color)


def pack(modules) -> torch.Tensor:
    """Flat [*lead, P] buffer: all weights, then all biases. Autograd
    routes the kernel's [*lead, P] gradient back through the cat."""
    lead = modules[0].b.shape[:-1]
    return torch.cat([m.w.reshape(*lead, -1) for m in modules]
                     + [m.b for m in modules], dim=-1)


def _unpack(flat: torch.Tensor, layers):
    lead = flat.shape[:-1]
    W, b, off = {}, {}, 0
    for k, i, o in layers:
        W[k] = flat[..., off:off + i * o].reshape(*lead, i, o)
        off += i * o
    for k, _, o in layers:
        b[k] = flat[..., off:off + o].unsqueeze(-2)
        off += o
    return W, b


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic, batched over leading dims)
# ---------------------------------------------------------------------------


def _embed(pts, B, inv_scale):
    """pts [..., N, 3], B [..., 21, 3] -> (t, proj [..., N, 21], emb1 [87],
    emb2 [42]); proj = t @ B^T summed in the kernel's order."""
    t = pts * inv_scale
    Bt = B.transpose(-1, -2).unsqueeze(-3)  # [..., 1, 3, 21]
    proj = (t[..., 0:1] * Bt[..., 0, :] + t[..., 1:2] * Bt[..., 1, :]
            + t[..., 2:3] * Bt[..., 2, :])
    sins = [torch.sin((math.pi * 2.0 ** f) * proj) for f in range(_N_FREQS)]
    emb1 = torch.cat([t] + sins[:4], dim=-1)
    emb2 = torch.cat(sins[4:], dim=-1)
    return t, proj, emb1, emb2


def _embed_bwd(demb1, demb2, t, proj, B, inv_scale):
    dproj = torch.zeros_like(proj)
    for f in range(_N_FREQS):
        ds = (demb1[..., 3 + N_DIRS * f: 3 + N_DIRS * (f + 1)] if f < 4
              else demb2[..., N_DIRS * (f - 4): N_DIRS * (f - 3)])
        w = math.pi * 2.0 ** f
        dproj = dproj + ds * (w * torch.cos(w * proj))
    dB = dproj.transpose(-1, -2) @ t
    dt = demb1[..., :3] + dproj @ B
    return dt * inv_scale, dB


def _codenerf_chain(emb1, emb2, zs0, zc, zs1, zt0, W, b, relu=None):
    """ref: _codenerf_chain (fused_field.py:81). W=32 splits the concat
    layers' weights into their two input blocks. `relu` (torch.relu, looked
    up at each call) lets codenerf_relu_margin see the pre-activations."""
    relu = torch.relu if relu is None else relu
    r0 = relu(emb1 @ W["e"] + b["e"])
    g0 = r0 + zs0
    r1 = relu(g0 @ W["s0"] + b["s0"])
    g1 = r1 + zc
    r2 = relu(g1 @ W["c"][..., :32, :] + emb1 @ W["c"][..., 32:, :]
              + b["c"])
    g2 = r2 + zs1
    r3 = relu(g2 @ W["s1"] + b["s1"])
    h = r3 @ W["en"] + b["en"]
    sg = (h @ W["sg"] + b["sg"]) * 10.0
    r4 = relu(h @ W["vd"][..., :32, :] + emb2 @ W["vd"][..., 32:, :]
              + b["vd"])
    g4 = r4 + zt0
    r5 = relu(g4 @ W["t0"] + b["t0"])
    r6 = relu(r5 @ W["r0"] + b["r0"])
    color = torch.sigmoid(r6 @ W["r1"] + b["r1"])
    iv = dict(r0=r0, g0=g0, r1=r1, g1=g1, r2=r2, g2=g2, r3=r3, h=h, r4=r4,
              g4=g4, r5=r5, r6=r6, color=color)
    return sg, color, iv


def codenerf_fwd_plain(flat, B, pts, zs, inv_scale):
    """flat [C, P], B [C, 21, 3], pts [C, N, 3], zs 4x [C, N, 32]
    -> out [C, N, 4] = [sigma x10 | rgb]."""
    W, b = _unpack(flat, CN_LAYERS)
    _, _, emb1, emb2 = _embed(pts, B, inv_scale)
    sg, color, _ = _codenerf_chain(emb1, emb2, *zs, W, b)
    return torch.cat([sg, color], dim=-1)


def codenerf_relu_margin(flat, B, pts, zs, inv_scale):
    """[C, N]: each row's smallest |pre-activation| over the seven ReLU
    layers of the CodeNeRF chain, in float64. Within float32 rounding of
    zero, two summation orders may disagree on the ReLU's derivative and so
    on the row's whole contribution to the backward; a check of a kernel's
    gradients leaves such rows out (dout = 0 there)."""
    margins = []

    def relu(a):
        margins.append(a.abs().amin(-1))
        return torch.relu(a)

    W, b = _unpack(flat.double(), CN_LAYERS)
    _, _, emb1, emb2 = _embed(pts.double(), B.double(), inv_scale)
    _codenerf_chain(emb1, emb2, *(z.double() for z in zs), W, b, relu=relu)
    return torch.stack(margins).amin(0)


def grad_bound(exact, plain, tol, layers=None):
    """The elementwise bound to which a kernel's float32 gradient is held
    on the card: tol (absolute plus relative) of the exact result (the plain
    version in float64), plus twice the float32 plain version's own largest
    error within the element's block: each layer's weights and each bias
    of a flat parameter gradient laid out by `layers`, else the whole
    tensor. A weight gradient that sums thousands of rows and cancels
    carries float32 rounding beyond tol in any order of summation (two
    orders differed by 7.5e-4 on a sigma-head weight gradient of 0.038 at
    C=8 x 3,600 rows on an H100), and its layer shares that
    conditioning."""
    perr = (plain.double() - exact).abs()
    if layers is None:
        block = perr.max().expand_as(perr)
    else:
        block = perr.clone()
        W, b = _unpack(block, layers)
        for v in (*W.values(), *b.values()):
            v.fill_(v.max())
    return tol * (1 + exact.abs()) + 2 * block


def _grads_flat(dW, db, layers):
    return torch.cat([dW[k].flatten(-2) for k, _, _ in layers]
                     + [db[k] for k, _, _ in layers], dim=-1)


def codenerf_bwd_plain(flat, B, pts, zs, dout, inv_scale):
    """Hand-derived backward (ref: _codenerf_bwd_kernel :135).
    Returns (dflat [C, P], dB [C, 21, 3], dpts, (dzs0, dzc, dzs1, dzt0))."""
    W, b = _unpack(flat, CN_LAYERS)
    t, proj, emb1, emb2 = _embed(pts, B, inv_scale)
    _, _, iv = _codenerf_chain(emb1, emb2, *zs, W, b)
    dsg = dout[..., 0:1] * 10.0
    dcol = dout[..., 1:4]
    dW, db = {}, {}

    def acc(k, x, d):
        dW[k] = x.transpose(-1, -2) @ d
        db[k] = d.sum(-2)

    def mT(d, w):
        return d @ w.transpose(-1, -2)

    da7 = dcol * iv["color"] * (1.0 - iv["color"])
    acc("r1", iv["r6"], da7)
    da6 = mT(da7, W["r1"]) * (iv["r6"] > 0)
    acc("r0", iv["r5"], da6)
    da5 = mT(da6, W["r0"]) * (iv["r5"] > 0)
    acc("t0", iv["g4"], da5)
    dg4 = mT(da5, W["t0"])
    da4 = dg4 * (iv["r4"] > 0)
    acc("vd", torch.cat([iv["h"], emb2], dim=-1), da4)
    dh = mT(da4, W["vd"][..., :32, :])
    demb2 = mT(da4, W["vd"][..., 32:, :])
    acc("sg", iv["h"], dsg)
    dh = dh + mT(dsg, W["sg"])
    acc("en", iv["r3"], dh)
    da3 = mT(dh, W["en"]) * (iv["r3"] > 0)
    acc("s1", iv["g2"], da3)
    dg2 = mT(da3, W["s1"])
    da2 = dg2 * (iv["r2"] > 0)
    acc("c", torch.cat([iv["g1"], emb1], dim=-1), da2)
    dg1 = mT(da2, W["c"][..., :32, :])
    demb1 = mT(da2, W["c"][..., 32:, :])
    da1 = dg1 * (iv["r1"] > 0)
    acc("s0", iv["g0"], da1)
    dg0 = mT(da1, W["s0"])
    da0 = dg0 * (iv["r0"] > 0)
    acc("e", emb1, da0)
    demb1 = demb1 + mT(da0, W["e"])
    dpts, dB = _embed_bwd(demb1, demb2, t, proj, B, inv_scale)
    return _grads_flat(dW, db, CN_LAYERS), dB, dpts, (dg0, dg1, dg2, dg4)


def _occ_chain(emb1, emb2, W, b, hidden=128):
    """ref: _occ_chain (fused_field.py:409)."""
    r0 = torch.relu(emb1 @ W["in"] + b["in"])
    r1 = torch.relu(r0 @ W["m1"] + b["m1"])
    r2 = torch.relu(r1 @ W["c"][..., :hidden, :]
                    + emb1 @ W["c"][..., hidden:, :] + b["c"])
    r3 = torch.relu(r2 @ W["m2"] + b["m2"])
    alpha = (r3 @ W["oa"] + b["oa"]) * 10.0
    r4 = torch.relu(r3 @ W["cl"][..., :hidden, :]
                    + emb2 @ W["cl"][..., hidden:, :] + b["cl"])
    color = torch.sigmoid(r4 @ W["oc"] + b["oc"])
    return alpha, color, dict(r0=r0, r1=r1, r2=r2, r3=r3, r4=r4, color=color)


def occupancy_fwd_plain(flat, B, pts, inv_scale):
    """flat [P], B [21, 3], pts [N, 3] -> out [N, 4] = [alpha x10 | rgb]."""
    W, b = _unpack(flat, OC_LAYERS)
    _, _, emb1, emb2 = _embed(pts, B, inv_scale)
    alpha, color, _ = _occ_chain(emb1, emb2, W, b)
    return torch.cat([alpha, color], dim=-1)


def occupancy_bwd_plain(flat, B, pts, dout, inv_scale, hidden=128):
    """ref: _occ_bwd_kernel :445. Returns (dflat [P], dB [21, 3], dpts)."""
    W, b = _unpack(flat, OC_LAYERS)
    t, proj, emb1, emb2 = _embed(pts, B, inv_scale)
    _, _, iv = _occ_chain(emb1, emb2, W, b, hidden)
    dalpha = dout[..., 0:1] * 10.0
    dcol = dout[..., 1:4]
    dW, db = {}, {}

    def acc(k, x, d):
        dW[k] = x.transpose(-1, -2) @ d
        db[k] = d.sum(-2)

    def mT(d, w):
        return d @ w.transpose(-1, -2)

    da5 = dcol * iv["color"] * (1.0 - iv["color"])
    acc("oc", iv["r4"], da5)
    da4 = mT(da5, W["oc"]) * (iv["r4"] > 0)
    acc("cl", torch.cat([iv["r3"], emb2], dim=-1), da4)
    dr3 = mT(da4, W["cl"][..., :hidden, :])
    demb2 = mT(da4, W["cl"][..., hidden:, :])
    acc("oa", iv["r3"], dalpha)
    dr3 = dr3 + mT(dalpha, W["oa"])
    da3 = dr3 * (iv["r3"] > 0)
    acc("m2", iv["r2"], da3)
    da2 = mT(da3, W["m2"]) * (iv["r2"] > 0)
    acc("c", torch.cat([iv["r1"], emb1], dim=-1), da2)
    dr1 = mT(da2, W["c"][..., :hidden, :])
    demb1 = mT(da2, W["c"][..., hidden:, :])
    da1 = dr1 * (iv["r1"] > 0)
    acc("m1", iv["r0"], da1)
    da0 = mT(da1, W["m1"]) * (iv["r0"] > 0)
    acc("in", emb1, da0)
    demb1 = demb1 + mT(da0, W["in"])
    dpts, dB = _embed_bwd(demb1, demb2, t, proj, B, inv_scale)
    return _grads_flat(dW, db, OC_LAYERS), dB, dpts


def codenerf_mlp_fwd_plain(flat, emb1, emb2, zs):
    """The chain alone on a precomputed embedding (ref: exp_kernel2.py
    mlp_kernel :73, `_codenerf_chain` :81): flat [C, P], emb1 [C, N, 87],
    emb2 [C, N, 42], zs 4x [C, N, 32] -> out [C, N, 4]."""
    W, b = _unpack(flat, CN_LAYERS)
    sg, color, _ = _codenerf_chain(emb1, emb2, *zs, W, b)
    return torch.cat([sg, color], dim=-1)


# --- the MLP-only kernel's load of its embedding (csrc/codenerf_fwd.cu) ---

EMB_BLOCK_ROWS = 64  # rows a block of the chain kernel


def emb_load_plain(emb1, emb2):
    """emb1 [N, 87], emb2 [N, 42] -> (out1 [ceil(N / 64), 87, 64], out2
    [ceil(N / 64), 42, 64]): each 64-row block k-major, as the chain kernel
    holds it in shared memory, rows past N zero."""
    nb = -(-emb1.shape[0] // EMB_BLOCK_ROWS)

    def image(x):
        pad = nb * EMB_BLOCK_ROWS - x.shape[0]
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(nb, EMB_BLOCK_ROWS, -1).transpose(1, 2).contiguous()

    return image(emb1), image(emb2)


# --- one layer of the forward chain kernel (csrc/codenerf_fwd.cu) ---

# The layers of the chain kernel in its order (its enum Layer): (name, the
# widths of the pieces of the layer's input, output width, epilogue). The
# last two are the packed forward's forms of the encoding and cat layers,
# which sum the products of t and of the PE apart (_cn2_chain :739); each
# takes the weights of the layer it splits.
TILE_LAYERS = (("e", (87,), 32, "relu_add"), ("s0", (32,), 32, "relu_add"),
               ("c", (32, 87), 32, "relu_add"), ("s1", (32,), 32, "relu"),
               ("en", (32,), 32, "bias"), ("sg", (32,), 1, "sigma"),
               ("vd", (32, 42), 32, "relu_add"), ("t0", (32,), 32, "relu"),
               ("r0", (32,), 16, "relu"), ("r1", (16,), 3, "sigmoid"),
               ("e_split", (3, 84), 32, "relu_add"),
               ("c_split", (32, 3, 84), 32, "relu_add"))
TILE_LAYER_NAMES = tuple(name for name, *_ in TILE_LAYERS)


def tile_layer_spec(layer: str):
    """(index in TILE_LAYERS, pieces, output width, epilogue) of a layer."""
    if layer not in TILE_LAYER_NAMES:
        raise ValueError(f"layer {layer!r} not in {TILE_LAYER_NAMES}")
    i = TILE_LAYER_NAMES.index(layer)
    return (i, *TILE_LAYERS[i][1:])


def tile_layer_plain(layer, x, w, bias, z=None):
    """One layer of the chain kernel, batched over leading dims: x [..., N,
    K] (the layer's pieces side by side), w [..., K, OUT], bias [..., OUT],
    z [..., N, OUT] (relu_add only):
      y = epi(((x_1 w_1 + x_2 w_2) + x_3 w_3) + bias), the products of the
    pieces added in order; relu_add: relu(.) + z; relu; bias: as it is;
    sigma: . x10; sigmoid."""
    _, pieces, _, epi = tile_layer_spec(layer)
    acc, k0 = None, 0
    for k in pieces:
        part = x[..., k0:k0 + k] @ w[..., k0:k0 + k, :]
        acc = part if acc is None else acc + part
        k0 += k
    y = acc + bias.unsqueeze(-2)
    if epi in ("relu", "relu_add"):
        y = torch.relu(y)
    if epi == "relu_add":
        y = y + z
    elif epi == "sigma":
        y = y * 10.0
    elif epi == "sigmoid":
        y = torch.sigmoid(y)
    return y


# --- the packed ensemble ("categories in lanes", ref: fused_field.py:640) ---


def fold_b2(B: torch.Tensor) -> torch.Tensor:
    """PE basis [C, 21, 3] -> B2 [C, 3, 126], B2[k, f*21+d] = B[d, k] *
    f32(pi 2^f), slots [f0..f3 | f4..f5] (ref: _pack_b2 :676-687; its two
    pad slots, zero, are left out)."""
    Bt = B.transpose(-1, -2)
    scaled = torch.stack([Bt * (math.pi * 2.0 ** f) for f in range(_N_FREQS)],
                         dim=-2)  # [C, 3, 6, 21]
    return scaled.reshape(*B.shape[:-2], 3, N_SLOTS)


def unfold_db2(dB2: torch.Tensor) -> torch.Tensor:
    """The gradient of fold_b2: dB[d, k] = sum_f f32(pi 2^f) dB2[k, f*21+d]."""
    w = math.pi * 2.0 ** torch.arange(_N_FREQS, dtype=dB2.dtype,
                                      device=dB2.device)
    split = dB2.reshape(*dB2.shape[:-1], _N_FREQS, N_DIRS)
    return (split * w[:, None]).sum(-2).transpose(-1, -2)


def _to_cat_major(x: torch.Tensor, C: int) -> torch.Tensor:
    """Point-major [N, C*k] -> [C, N, k]."""
    return x.reshape(x.shape[0], C, -1).transpose(0, 1)


def to_point_major(x: torch.Tensor) -> torch.Tensor:
    """[C, N, k] -> point-major [N, C*k]."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def _cn2_chain(t, S, zs0, zc, zs1, zt0, W, b):
    """ref: _cn2_chain :739-770, per category: the concat layers are split
    products over [y | t | S] (We_t / We_s = We[:3] / We[3:87]; Wc_y / Wc_t
    / Wc_s = Wc[:32] / Wc[32:35] / Wc[35:119]; Wvd_h / Wvd_s = Wvd[:32] /
    Wvd[32:74], the last over S's slots 84..125)."""
    S_lo, S_hi = S[..., :_LOW], S[..., _LOW:]
    We, Wc, Wvd = W["e"], W["c"], W["vd"]
    a0 = t @ We[..., :3, :] + S_lo @ We[..., 3:, :] + b["e"]
    r0 = torch.relu(a0)
    g0 = r0 + zs0
    r1 = torch.relu(g0 @ W["s0"] + b["s0"])
    g1 = r1 + zc
    a2 = (g1 @ Wc[..., :32, :] + t @ Wc[..., 32:35, :]
          + S_lo @ Wc[..., 35:, :] + b["c"])
    r2 = torch.relu(a2)
    g2 = r2 + zs1
    r3 = torch.relu(g2 @ W["s1"] + b["s1"])
    h = r3 @ W["en"] + b["en"]
    sg = (h @ W["sg"] + b["sg"]) * 10.0
    r4 = torch.relu(h @ Wvd[..., :32, :] + S_hi @ Wvd[..., 32:, :] + b["vd"])
    g4 = r4 + zt0
    r5 = torch.relu(g4 @ W["t0"] + b["t0"])
    r6 = torch.relu(r5 @ W["r0"] + b["r0"])
    color = torch.sigmoid(r6 @ W["r1"] + b["r1"])
    iv = dict(r0=r0, g0=g0, r1=r1, g1=g1, r2=r2, g2=g2, r3=r3, h=h, r4=r4,
              g4=g4, r5=r5, r6=r6, color=color)
    return sg, color, iv


def _packed_inputs(flat, B, pts, zs, inv_scale):
    C = flat.shape[0]
    t = _to_cat_major(pts, C) * inv_scale
    B2 = fold_b2(B)
    sinarg = t @ B2  # [C, N, 126]
    return (C, t, B2, sinarg, torch.sin(sinarg),
            [_to_cat_major(z, C) for z in zs])


def codenerf_packed_fwd_plain(flat, B, pts, zs, inv_scale):
    """flat [C, P], B [C, 21, 3], pts [N, 3C], zs 4x [N, 32C] ->
    (sigma [N, C], rgb [N, 3C]) (ref: _cn2_fwd_kernel :773)."""
    W, b = _unpack(flat, CN_LAYERS)
    _, t, _, _, S, zc = _packed_inputs(flat, B, pts, zs, inv_scale)
    sg, color, _ = _cn2_chain(t, S, *zc, W, b)
    return to_point_major(sg), to_point_major(color)


def codenerf_packed_bwd_plain(flat, B, pts, zs, dsg, dcol, inv_scale):
    """Hand-derived backward, operation for operation as _cn2_bwd_kernel
    :786-858 but per category (the block diagonal's off-diagonal cotangents
    are dropped by the JAX caller's autodiff). Returns (dflat [C, P],
    dB2 [C, 3, 126], dpts [N, 3C], (dzs0, dzc, dzs1, dzt0) [N, 32C])."""
    W, b = _unpack(flat, CN_LAYERS)
    C, t, B2, sinarg, S, zc = _packed_inputs(flat, B, pts, zs, inv_scale)
    _, _, iv = _cn2_chain(t, S, *zc, W, b)
    S_lo, S_hi = S[..., :_LOW], S[..., _LOW:]
    We, Wc, Wvd = W["e"], W["c"], W["vd"]
    dsg = _to_cat_major(dsg, C) * 10.0
    dcol = _to_cat_major(dcol, C)

    def xTd(x, d):
        return x.transpose(-1, -2) @ d

    def mT(d, w):
        return d @ w.transpose(-1, -2)

    dW, db = {}, {}
    da7 = dcol * iv["color"] * (1.0 - iv["color"])
    dW["r1"], db["r1"] = xTd(iv["r6"], da7), da7.sum(-2)
    da6 = mT(da7, W["r1"]) * (iv["r6"] > 0)
    dW["r0"], db["r0"] = xTd(iv["r5"], da6), da6.sum(-2)
    da5 = mT(da6, W["r0"]) * (iv["r5"] > 0)
    dW["t0"], db["t0"] = xTd(iv["g4"], da5), da5.sum(-2)
    dg4 = mT(da5, W["t0"])
    da4 = dg4 * (iv["r4"] > 0)
    dW["vd"] = torch.cat([xTd(iv["h"], da4), xTd(S_hi, da4)], dim=-2)
    db["vd"] = da4.sum(-2)
    dW["sg"], db["sg"] = xTd(iv["h"], dsg), dsg.sum(-2)
    dh = mT(da4, Wvd[..., :32, :]) + mT(dsg, W["sg"])
    dW["en"], db["en"] = xTd(iv["r3"], dh), dh.sum(-2)
    da3 = mT(dh, W["en"]) * (iv["r3"] > 0)
    dW["s1"], db["s1"] = xTd(iv["g2"], da3), da3.sum(-2)
    dg2 = mT(da3, W["s1"])
    da2 = dg2 * (iv["r2"] > 0)
    dW["c"] = torch.cat([xTd(iv["g1"], da2), xTd(t, da2), xTd(S_lo, da2)],
                        dim=-2)
    db["c"] = da2.sum(-2)
    dg1 = mT(da2, Wc[..., :32, :])
    da1 = dg1 * (iv["r1"] > 0)
    dW["s0"], db["s0"] = xTd(iv["g0"], da1), da1.sum(-2)
    dg0 = mT(da1, W["s0"])
    da0 = dg0 * (iv["r0"] > 0)
    dW["e"] = torch.cat([xTd(t, da0), xTd(S_lo, da0)], dim=-2)
    db["e"] = da0.sum(-2)

    dS = torch.cat([mT(da0, We[..., 3:, :]) + mT(da2, Wc[..., 35:, :]),
                    mT(da4, Wvd[..., 32:, :])], dim=-1)
    dsinarg = dS * torch.cos(sinarg)
    dB2 = xTd(t, dsinarg)
    dt = (mT(dsinarg, B2) + mT(da0, We[..., :3, :])) + mT(da2, Wc[..., 32:35, :])
    return (_grads_flat(dW, db, CN_LAYERS), dB2,
            to_point_major(dt * inv_scale),
            tuple(to_point_major(d) for d in (dg0, dg1, dg2, dg4)))


# --- the tile pieces of the packed backward (csrc/codenerf_packed.cu) ---

# The input-gradient products of the tiled backward in its order (its enum
# DxPiece): (name, the layer in CN_LAYERS, the first of the rows of its
# weight block that the piece reads, their count KOUT, epilogue). Each is
# dX = D W[k0:k0+KOUT]^T over the layer's output width; the split concat
# layers take their pieces as the forward does ([g1 | t | S_lo], [t |
# S_lo], [h | S_hi]). mask: dX [a > 0]; grad_mask: dX (an injection's
# gradient) and dX [a > 0]; outer: + dsg W_sg^T (the sigma head's term of
# dh); accumulate: + the cat layer's part of dS[0:84], as
# codenerf_packed_bwd_plain adds them.
PACKED_DX_PIECES = (("r1", "r1", 0, 16, "mask"), ("r0", "r0", 0, 32, "mask"),
                    ("t0", "t0", 0, 32, "grad_mask"),
                    ("vd_h", "vd", 0, 32, "outer"),
                    ("vd_s", "vd", 32, 42, "store"),
                    ("en", "en", 0, 32, "mask"),
                    ("s1", "s1", 0, 32, "grad_mask"),
                    ("c_y", "c", 0, 32, "grad_mask"),
                    ("c_t", "c", 32, 3, "store"),
                    ("c_s", "c", 35, 84, "store"),
                    ("s0", "s0", 0, 32, "grad_mask"),
                    ("e_t", "e", 0, 3, "store"),
                    ("e_s", "e", 3, 84, "accumulate"))
PACKED_DX_NAMES = tuple(name for name, *_ in PACKED_DX_PIECES)
# The weight gradients of the tiled backward in its order (its enum
# WgLayer): (name, the widths of the pieces of the layer's input, output
# width, with a bias sum). dW = X^T D over the block's rows, db = the sum
# of D; "b2" is dB2 = t^T dsinarg.
PACKED_BWD_LAYERS = (("r1", (16,), 3, True), ("r0", (32,), 16, True),
                     ("t0", (32,), 32, True), ("vd", (32, 42), 32, True),
                     ("sg", (32,), 1, True), ("en", (32,), 32, True),
                     ("s1", (32,), 32, True), ("c", (32, 87), 32, True),
                     ("s0", (32,), 32, True), ("e", (87,), 32, True),
                     ("b2", (3,), N_SLOTS, False))
PACKED_BWD_NAMES = tuple(name for name, *_ in PACKED_BWD_LAYERS)


def packed_dx_spec(piece: str):
    """(index in PACKED_DX_PIECES, layer, k0, KOUT, KIN, epilogue)."""
    if piece not in PACKED_DX_NAMES:
        raise ValueError(f"piece {piece!r} not in {PACKED_DX_NAMES}")
    i = PACKED_DX_NAMES.index(piece)
    _, layer, k0, kout, epi = PACKED_DX_PIECES[i]
    kin = next(o for k, _, o in CN_LAYERS if k == layer)
    return i, layer, k0, kout, kin, epi


def packed_wgrad_spec(layer: str):
    """(index in PACKED_BWD_LAYERS, pieces, output width, bias)."""
    if layer not in PACKED_BWD_NAMES:
        raise ValueError(f"layer {layer!r} not in {PACKED_BWD_NAMES}")
    i = PACKED_BWD_NAMES.index(layer)
    return (i, *PACKED_BWD_LAYERS[i][1:])


def tile_dx_plain(piece, d, w, a=None, d1=None, w1=None, acc=None):
    """One input-gradient piece of the tiled packed backward, batched over
    leading dims: d [..., N, KIN], w [..., KOUT, KIN] (its rows of the
    layer's weight block) -> (y [..., N, KOUT], dz): y = d w^T, then the
    piece's epilogue: mask (a [..., N, KOUT] the pre-activation) y [a > 0];
    grad_mask the same, with dz = d w^T (else dz is None); outer + d1 w1^T
    (d1 [..., N, 1], w1 [..., KOUT, 1]); accumulate + acc [..., N, KOUT]."""
    epi = packed_dx_spec(piece)[-1]
    y = d @ w.transpose(-1, -2)
    dz = None
    if epi == "outer":
        y = y + d1 @ w1.transpose(-1, -2)
    elif epi == "accumulate":
        y = y + acc
    elif epi in ("mask", "grad_mask"):
        dz = y if epi == "grad_mask" else None
        y = y * (a > 0)
    return y, dz


def tile_wgrad_plain(layer, x, d):
    """One weight gradient of the tiled packed backward, batched over
    leading dims: x [..., N, K] (the layer's input pieces side by side),
    d [..., N, OUT] -> (dw = x^T d [..., K, OUT], db = the sum of d over
    the rows [..., OUT], or None for b2)."""
    bias = packed_wgrad_spec(layer)[-1]
    return x.transpose(-1, -2) @ d, d.sum(-2) if bias else None


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/codenerf_fwd.cu, csrc/codenerf_bwd.cu,
# csrc/occupancy.cu, csrc/codenerf_packed.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "codenerf_fwd": {
        "cn_fwd": [_P] * 8 + [_I, _I, _F, _P],
        "cn2_fwd": [_P] * 9 + [_I, _I, _F, _P],
        "cn_mlp_fwd": [_P] * 8 + [_I, _I, _P],
        # layer (TILE_LAYERS index); x, w, bias, z, y; N; stream
        "cn_tile_layer": [_I] + [_P] * 5 + [_I, _P],
        # emb1, emb2, out1, out2; N; stream
        "cn_emb_load": [_P] * 4 + [_I, _P],
        "cn_sin": [_P, _P, _I, _P],
        "codenerf_fwd_layout": [ctypes.POINTER(ctypes.c_int)],
    },
    "codenerf_packed": {
        "cn2_bwd": [_P] * 16 + [_I, _I, _F, _P],
        # piece (PACKED_DX_PIECES index); d, w, a, d1, w1, acc, y, dz; N;
        # stream
        "cn2_tile_dx": [_I] + [_P] * 8 + [_I, _P],
        # layer (PACKED_BWD_LAYERS index); x, d, partial, out; N; stream
        "cn2_tile_wgrad": [_I] + [_P] * 4 + [_I, _P],
        "cn_cos": [_P, _P, _I, _P],
        "packed_layout": [ctypes.POINTER(ctypes.c_int)],
    },
    "occupancy": {
        "oc_fwd": [_P] * 5 + [_I, _F, _P],
        "oc_bwd": [_P] * 8 + [_I, _F, _P],
        "oc_gemm": [_I, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _I,
                    _I, _P, _P, _P],
        "occupancy_layout": [ctypes.POINTER(ctypes.c_int)],
    },
    "codenerf_bwd": {
        "cn_bwd": [_P] * 16 + [_I, _I, _F, _P],
        # layout, epilogue, batch; A, lda, sA; B, ldb, sB; C, ldc, sC;
        # M, N, K; bias, sbias; mask, ldm, smask, mask_cols; Z, ldz, sZ;
        # C2, ldc2, sC2; stream
        "cn_gemm": [_I, _I, _I] + [_P, _I, _I] * 3 + [_I, _I, _I, _P, _I,
                                                       _P, _I, _I, _I]
                   + [_P, _I, _I] * 2 + [_P],
        "codenerf_bwd_layout": [ctypes.POINTER(ctypes.c_int)],
    },
}
LIBRARIES = tuple(_SIGNATURES)
# library -> (its layout function, the names of the ints it writes, the
# values the wrapper relies on)
_LAYOUT_FNS = {
    "codenerf_fwd": ("codenerf_fwd_layout",
                     ("cn_fwd_p", "cn_fwd_rows", "cn_fwd_threads",
                      "cn_fwd_smem"),
                     {"cn_fwd_p": CN_P, "cn_fwd_rows": EMB_BLOCK_ROWS}),
    "codenerf_packed": ("packed_layout",
                        ("packed_p", "packed_b2", "packed_block_rows",
                         "packed_threads", "packed_smem"),
                        {"packed_p": CN_P, "packed_b2": B2_SIZE,
                         "packed_block_rows": PACKED_BLOCK_ROWS}),
    "occupancy": ("occupancy_layout",
                  ("oc_p", "oc_pp", "oc_chunks", "oc_ws_cols",
                   "oc_fwd_ws_cols"),
                  {"oc_p": OC_P, "oc_pp": OC_P + B_SIZE}),
    "codenerf_bwd": ("codenerf_bwd_layout",
                     ("cn_bwd_p", "cn_bwd_pp", "cn_bwd_chunks",
                      "cn_bwd_ws_cols"),
                     {"cn_bwd_p": CN_P, "cn_bwd_pp": CN_P + B_SIZE}),
}
# tile sizes (rows per block) and layouts, read from the libraries
_LAYOUT: dict[str, int] = {}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    for fn_name, args in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    fn_name, keys, want = _LAYOUT_FNS[name]
    out = (ctypes.c_int * len(keys))()
    getattr(lib, fn_name)(out)
    got = dict(zip(keys, out))
    if {k: got[k] for k in want} != want:
        raise RuntimeError(f"{name}.cu layout {got} does not match the "
                           f"wrapper's {want}")
    _LAYOUT.update(got)


_BOUND: set[str] = set()


def _lib(name: str) -> ctypes.CDLL:
    from catnerf_torch.kernels import build

    lib = build.load(name)
    if name not in _BOUND:
        _bind(name, lib)
        _BOUND.add(name)
    return lib


def load_libraries() -> None:
    """Build every kernel library (one nvcc each, all at once) and bind."""
    from catnerf_torch.kernels import build

    build.load_all(LIBRARIES)
    for name in LIBRARIES:
        _lib(name)


def layout() -> dict[str, int]:
    """The kernels' tile sizes and parameter counts (builds the libraries)."""
    load_libraries()
    return dict(_LAYOUT)


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _check(device, shapes: dict, aligned=("params",)):
    """Every kernel argument: float32, contiguous, on `device`, with the
    given shape; those named in `aligned` 16-byte aligned (float4 loads)."""
    for name, (x, shape) in shapes.items():
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {device}, got "
                             f"{x.dtype} on {x.device}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    for name in aligned:
        if shapes[name][0].data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_Z_NAMES = ("z0", "z1", "z2", "z3")


def codenerf_fwd_cuda(flat, B, pts, zs, inv_scale):
    """csrc/codenerf_fwd.cu `cn_fwd`: the tiled chain kernel, one launch
    (grid: row tiles of `cn_fwd_rows` x the categories)."""
    lib = _lib("codenerf_fwd")
    C, N, _ = pts.shape
    _check(pts.device, {"pts": (pts, (C, N, 3)), "params": (flat, (C, CN_P)),
                        "B": (B, (C, N_DIRS, 3)),
                        **{k: (z, (C, N, 32)) for k, z in zip(_Z_NAMES, zs)}},
           aligned=("params", *_Z_NAMES))
    out = torch.empty(C, N, 4, device=pts.device, dtype=torch.float32)
    if N == 0:
        return out
    err = lib.cn_fwd(_ptr(pts), *(_ptr(z) for z in zs), _ptr(flat), _ptr(B),
                     _ptr(out), C, N, inv_scale, _stream(pts.device))
    _raise_on(err, "cn_fwd")
    LAUNCHES["codenerf_fwd"] += 1
    return out


def codenerf_bwd_cuda(flat, B, pts, zs, dout, inv_scale):
    """csrc/codenerf_bwd.cu: the recompute and the backward as a chain of
    tiled GEMMs (the category their batch index) and row kernels, its
    activations and deltas in a workspace of `cn_bwd_ws_cols` floats a row
    and category (rows rounded up to 4), the weight gradients as
    `cn_bwd_chunks` per-chunk partials a category, reduced in order."""
    lib = _lib("codenerf_bwd")
    C, N, _ = pts.shape
    _check(pts.device, {"pts": (pts, (C, N, 3)), "params": (flat, (C, CN_P)),
                        "B": (B, (C, N_DIRS, 3)), "dout": (dout, (C, N, 4)),
                        **{f"z{i}": (z, (C, N, 32)) for i, z in enumerate(zs)}})
    dev = pts.device
    dpts = torch.empty_like(pts)
    dzs = [torch.empty_like(z) for z in zs]
    grads = torch.empty(C, CN_P + B_SIZE, device=dev, dtype=torch.float32)
    if N == 0:
        grads.zero_()
    else:
        partial = torch.empty(C, _LAYOUT["cn_bwd_chunks"], CN_P + B_SIZE,
                              device=dev, dtype=torch.float32)
        workspace = torch.empty(
            C * -(-N // 4) * 4 * _LAYOUT["cn_bwd_ws_cols"], device=dev,
            dtype=torch.float32)
        err = lib.cn_bwd(_ptr(pts), *(_ptr(z) for z in zs), _ptr(flat),
                         _ptr(B), _ptr(dout), _ptr(dpts),
                         *(_ptr(z) for z in dzs), _ptr(partial), _ptr(grads),
                         _ptr(workspace), C, N, inv_scale, _stream(dev))
        _raise_on(err, "cn_bwd")
        LAUNCHES["codenerf_bwd"] += 1
    return (grads[:, :CN_P], grads[:, CN_P:].reshape(C, N_DIRS, 3), dpts,
            tuple(dzs))


def occupancy_fwd_cuda(flat, B, pts, inv_scale):
    """csrc/occupancy.cu: the PE and the five wide layers as tiled GEMMs,
    then a head kernel; the activations in a workspace of `oc_fwd_ws_cols`
    floats a row (rows rounded up to 4)."""
    lib = _lib("occupancy")
    N = pts.shape[0]
    _check(pts.device, {"pts": (pts, (N, 3)), "params": (flat, (OC_P,)),
                        "B": (B, (N_DIRS, 3))})
    dev = pts.device
    out = torch.empty(N, 4, device=dev, dtype=torch.float32)
    if N == 0:
        return out
    workspace = torch.empty(-(-N // 4) * 4 * _LAYOUT["oc_fwd_ws_cols"],
                            device=dev, dtype=torch.float32)
    err = lib.oc_fwd(_ptr(pts), _ptr(flat), _ptr(B), _ptr(out),
                     _ptr(workspace), N, inv_scale, _stream(dev))
    _raise_on(err, "oc_fwd")
    LAUNCHES["occupancy_fwd"] += 1
    return out


def occupancy_bwd_cuda(flat, B, pts, dout, inv_scale):
    """csrc/occupancy.cu: the recompute and the backward as a chain of
    tiled GEMMs and row kernels, its activations and deltas in a workspace
    of `oc_ws_cols` floats a row (rows rounded up to 4), the weight
    gradients as `oc_chunks` per-chunk partials reduced in order."""
    lib = _lib("occupancy")
    N = pts.shape[0]
    _check(pts.device, {"pts": (pts, (N, 3)), "params": (flat, (OC_P,)),
                        "B": (B, (N_DIRS, 3)), "dout": (dout, (N, 4))})
    dev = pts.device
    dpts = torch.empty_like(pts)
    grads = torch.empty(OC_P + B_SIZE, device=dev, dtype=torch.float32)
    if N == 0:
        grads.zero_()
    else:
        partial = torch.empty(_LAYOUT["oc_chunks"], OC_P + B_SIZE,
                              device=dev, dtype=torch.float32)
        workspace = torch.empty(-(-N // 4) * 4 * _LAYOUT["oc_ws_cols"],
                                device=dev, dtype=torch.float32)
        err = lib.oc_bwd(_ptr(pts), _ptr(flat), _ptr(B), _ptr(dout),
                         _ptr(dpts), _ptr(partial), _ptr(grads),
                         _ptr(workspace), N, inv_scale, _stream(dev))
        _raise_on(err, "oc_bwd")
        LAUNCHES["occupancy_bwd"] += 1
    return grads[:OC_P], grads[OC_P:].reshape(N_DIRS, 3), dpts


GEMM_LAYOUTS = ("nn", "nt", "tn")
# the epilogues of csrc/gemm_f32.cuh, in its order
GEMM_EPILOGUES = ("bias_relu", "mask", "accumulate", "bias", "bias_relu_add",
                  "grad_mask")
# oc_gemm (the 128-wide block) builds every layout with the first three;
# cn_gemm (the 32-wide, batched) the pairs the CodeNeRF backward uses
OC_GEMM_EPILOGUES = GEMM_EPILOGUES[:3]
CN_GEMM_CASES = (("nn", "bias_relu"), ("nn", "bias"), ("nn", "bias_relu_add"),
                 ("nt", "mask"), ("nt", "accumulate"), ("nt", "grad_mask"),
                 ("tn", "mask"))


def _gemm_operands(layout, a, b):
    """op(a) [..., M, K], op(b) [..., K, N] of a layout: nn a [M, K],
    b [K, N]; nt a [M, K], b [N, K]; tn a [K, M], b [K, N]."""
    if layout not in GEMM_LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {GEMM_LAYOUTS}")
    t = lambda x: x.transpose(-1, -2)
    return (t(a) if layout == "tn" else a), (t(b) if layout == "nt" else b)


def gemm_plain(layout, epilogue, a, b, c, bias=None, mask=None, u=None,
               v=None, z=None, c2=None):
    """The GEMM block of csrc/gemm_f32.cuh, batched over leading dims:
    c [..., M, N] (a view, written in place) = epilogue(op(a) @ op(b)).
      bias_relu: relu(. + bias[..., N]);  bias: . + bias;
      bias_relu_add: relu(. + bias), and c2 = that + z;
      mask: on the first mask.shape[-1] columns (. + u v^T) * [mask > 0]
        (u, v optional), the other columns as they are (no mask: a plain
        store);
      grad_mask: ., and c2 = .[..., :k] * [mask > 0] (k = mask's width);
      accumulate: c + . .
    Returns c."""
    A, Bm = _gemm_operands(layout, a, b)
    p = A @ Bm
    if epilogue in ("bias_relu", "bias", "bias_relu_add"):
        p = p + bias.unsqueeze(-2)
        if epilogue != "bias":
            p = torch.relu(p)
        if epilogue == "bias_relu_add":
            c2.copy_(p + z)
    elif epilogue == "mask":
        if mask is not None:
            k = mask.shape[-1]
            head = p[..., :k]
            if u is not None:
                head = head + u.unsqueeze(-1) * v.unsqueeze(-2)
            p = torch.cat([head * (mask > 0), p[..., k:]], dim=-1)
    elif epilogue == "grad_mask":
        c2.copy_(p[..., :mask.shape[-1]] * (mask > 0))
    elif epilogue == "accumulate":
        p = c + p
    else:
        raise ValueError(f"epilogue {epilogue!r} not in {GEMM_EPILOGUES}")
    return c.copy_(p)


def _same_device_f32(what, device, tensors):
    for name, x in tensors:
        if x is not None and (x.device != device
                              or x.dtype != torch.float32):
            raise ValueError(f"{what}: {name} must be float32 on {device}")


def oc_gemm_cuda(layout, epilogue, a, b, c, bias=None, mask=None, u=None,
                 v=None):
    """gemm_plain's contract for the 128-wide block on the card, one
    product, epilogues OC_GEMM_EPILOGUES: every matrix a float32 view on
    one device with unit column stride (the row stride is its leading
    dimension); bias, u and v contiguous."""
    lib = _lib("occupancy")
    if epilogue not in OC_GEMM_EPILOGUES:
        raise ValueError(f"oc_gemm: epilogue {epilogue!r} not in "
                         f"{OC_GEMM_EPILOGUES}")
    A, Bm = _gemm_operands(layout, a, b)
    (M, K), (K2, N) = A.shape, Bm.shape
    if K2 != K or tuple(c.shape) != (M, N):
        raise ValueError(f"oc_gemm: op(a) {tuple(A.shape)}, op(b) "
                         f"{tuple(Bm.shape)}, c {tuple(c.shape)}")
    vecs = {"bias": (bias, N), "u": (u, M),
            "v": (v, None if mask is None else mask.shape[1])}
    for name, x in (("a", a), ("b", b), ("c", c), ("mask", mask)):
        if x is not None and (x.dim() != 2 or x.stride(1) != 1):
            raise ValueError(f"oc_gemm: {name} needs unit column stride")
    for name, (x, n) in vecs.items():
        if x is not None and (x.shape != (n,) or not x.is_contiguous()):
            raise ValueError(f"oc_gemm: {name} must be contiguous [{n}]")
    _same_device_f32("oc_gemm", c.device, (("a", a), ("b", b), ("c", c),
                                           ("bias", bias), ("mask", mask),
                                           ("u", u), ("v", v)))
    if epilogue == "bias_relu" and bias is None:
        raise ValueError("oc_gemm: bias_relu needs a bias")
    if mask is not None and (mask.shape[0] != M or mask.shape[1] > N):
        raise ValueError(f"oc_gemm: mask {tuple(mask.shape)} for c [{M}, {N}]")
    if (u is None) != (v is None):
        raise ValueError("oc_gemm: u and v go together")
    opt = lambda x: 0 if x is None else _ptr(x)
    err = lib.oc_gemm(GEMM_LAYOUTS.index(layout),
                      GEMM_EPILOGUES.index(epilogue), _ptr(a), a.stride(0),
                      _ptr(b), b.stride(0), _ptr(c), c.stride(0), M, N, K,
                      opt(bias), opt(mask),
                      0 if mask is None else mask.stride(0),
                      0 if mask is None else mask.shape[1], opt(u), opt(v),
                      _stream(c.device))
    _raise_on(err, "oc_gemm")
    LAUNCHES["oc_gemm"] += 1
    return c


def cn_gemm_cuda(layout, epilogue, a, b, c, bias=None, mask=None, z=None,
                 c2=None):
    """gemm_plain's contract for the 32-wide block on the card, batched
    over one leading dim (the category, blockIdx.z), for the pairs of
    CN_GEMM_CASES: every matrix [C, rows, cols] and every vector [C, n] a
    float32 view with unit column stride (rows and batches at any stride
    below 2^31 floats)."""
    lib = _lib("codenerf_bwd")
    if (layout, epilogue) not in CN_GEMM_CASES:
        raise ValueError(f"cn_gemm: ({layout!r}, {epilogue!r}) not in "
                         f"{CN_GEMM_CASES}")
    A, Bm = _gemm_operands(layout, a, b)
    (C, M, K), (C2, K2, N) = A.shape, Bm.shape
    if (C2, K2) != (C, K) or tuple(c.shape) != (C, M, N):
        raise ValueError(f"cn_gemm: op(a) {tuple(A.shape)}, op(b) "
                         f"{tuple(Bm.shape)}, c {tuple(c.shape)}")
    k = 0 if mask is None else mask.shape[-1]
    want = {"a": (a, 3, None), "b": (b, 3, None), "c": (c, 3, None),
            "bias": (bias, 2, (C, N)), "mask": (mask, 3, (C, M, k)),
            "z": (z, 3, (C, M, N)),
            "c2": (c2, 3, (C, M, N if epilogue == "bias_relu_add" else k))}
    for name, (x, dim, shape) in want.items():
        if x is None:
            continue
        if x.dim() != dim or x.stride(-1) != 1 or max(x.stride()) >= 2**31:
            raise ValueError(f"cn_gemm: {name} needs {dim} dims, unit column "
                             f"stride and strides below 2^31")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"cn_gemm: {name} {tuple(x.shape)} != {shape}")
    _same_device_f32("cn_gemm", c.device,
                     [(name, x) for name, (x, _, _) in want.items()])
    needs = {"bias_relu": ("bias",), "bias": ("bias",),
             "bias_relu_add": ("bias", "z", "c2"),
             "grad_mask": ("mask", "c2")}.get(epilogue, ())
    if any(want[name][0] is None for name in needs):
        raise ValueError(f"cn_gemm: {epilogue} needs {needs}")
    if k > N:
        raise ValueError(f"cn_gemm: mask {tuple(mask.shape)} for c "
                         f"{tuple(c.shape)}")
    ptr = lambda x: 0 if x is None else _ptr(x)
    ld = lambda x: 0 if x is None else x.stride(-2)
    bs = lambda x: 0 if x is None else x.stride(0)
    err = lib.cn_gemm(GEMM_LAYOUTS.index(layout),
                      GEMM_EPILOGUES.index(epilogue), C,
                      ptr(a), ld(a), bs(a), ptr(b), ld(b), bs(b),
                      ptr(c), ld(c), bs(c), M, N, K, ptr(bias), bs(bias),
                      ptr(mask), ld(mask), bs(mask), k, ptr(z), ld(z), bs(z),
                      ptr(c2), ld(c2), bs(c2), _stream(c.device))
    _raise_on(err, "cn_gemm")
    LAUNCHES["cn_gemm"] += 1
    return c


def cn_tile_layer_cuda(layer, x, w, bias, z=None):
    """csrc/codenerf_fwd.cu `cn_tile_layer`: one layer of the chain kernel
    alone (tile_layer_plain's contract without leading dims), through the
    chain kernel's own code for it; a test entry. x [N, K], w [K, OUT],
    bias [OUT], z [N, OUT] (relu_add only) -> y [N, OUT], all float32,
    contiguous, on one CUDA device."""
    index, pieces, out, epi = tile_layer_spec(layer)
    N, K = x.shape[0], sum(pieces)
    if (z is not None) != (epi == "relu_add"):
        raise ValueError(f"cn_tile_layer: {layer} takes z only with a "
                         f"relu_add epilogue ({epi})")
    shapes = {"x": (x, (N, K)), "w": (w, (K, out)), "bias": (bias, (out,)),
              **({} if z is None else {"z": (z, (N, out))})}
    _check(x.device, shapes, aligned=() if z is None else ("z",))
    lib = _lib("codenerf_fwd")
    y = torch.empty(N, out, device=x.device, dtype=torch.float32)
    if N == 0:
        return y
    err = lib.cn_tile_layer(index, _ptr(x), _ptr(w), _ptr(bias),
                            0 if z is None else _ptr(z), _ptr(y), N,
                            _stream(x.device))
    _raise_on(err, "cn_tile_layer")
    LAUNCHES["cn_tile"] += 1
    return y


def cn_sin_cuda(x):
    """csrc/codenerf_fwd.cu `cn_sin`: the chain kernel's sine (`sin_f32`,
    accurate over all floats, nothing in local memory) alone; a test
    entry. x float32, contiguous, on a CUDA device."""
    _check(x.device, {"x": (x, tuple(x.shape))}, aligned=())
    lib = _lib("codenerf_fwd")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _raise_on(lib.cn_sin(_ptr(x), _ptr(y), x.numel(), _stream(x.device)),
              "cn_sin")
    LAUNCHES["cn_sin"] += 1
    return y


def codenerf_mlp_fwd_cuda(flat, emb1, emb2, zs):
    """csrc/codenerf_fwd.cu `cn_mlp_fwd`: the tiled chain kernel with the
    embedding loaded from device memory, one launch (grid: row tiles of
    `cn_fwd_rows` x the categories)."""
    lib = _lib("codenerf_fwd")
    C, N, _ = emb1.shape
    _check(emb1.device, {"emb1": (emb1, (C, N, 87)),
                         "emb2": (emb2, (C, N, 42)),
                         "params": (flat, (C, CN_P)),
                         **{k: (z, (C, N, 32)) for k, z in zip(_Z_NAMES, zs)}},
           aligned=("params", *_Z_NAMES))
    out = torch.empty(C, N, 4, device=emb1.device, dtype=torch.float32)
    if N == 0:
        return out
    err = lib.cn_mlp_fwd(_ptr(emb1), _ptr(emb2), *(_ptr(z) for z in zs),
                         _ptr(flat), _ptr(out), C, N, _stream(emb1.device))
    _raise_on(err, "cn_mlp_fwd")
    LAUNCHES["codenerf_mlp_fwd"] += 1
    return out


def cn_emb_load_cuda(emb1, emb2):
    """csrc/codenerf_fwd.cu `cn_emb_load`: the MLP-only kernel's load of
    its embedding alone (its `load_emb`, staging no weights); a test entry.
    emb1 [N, 87], emb2 [N, 42] -> the k-major image of each 64-row block
    (emb_load_plain's contract)."""
    N = emb1.shape[0]
    _check(emb1.device, {"emb1": (emb1, (N, 87)), "emb2": (emb2, (N, 42))},
           aligned=())
    lib = _lib("codenerf_fwd")
    nb = -(-N // EMB_BLOCK_ROWS)
    out1 = torch.empty(nb, 87, EMB_BLOCK_ROWS, device=emb1.device)
    out2 = torch.empty(nb, 42, EMB_BLOCK_ROWS, device=emb1.device)
    if N == 0:
        return out1, out2
    err = lib.cn_emb_load(_ptr(emb1), _ptr(emb2), _ptr(out1), _ptr(out2), N,
                          _stream(emb1.device))
    _raise_on(err, "cn_emb_load")
    LAUNCHES["cn_emb"] += 1
    return out1, out2


def check_tile(tile) -> int:
    """The packed kernels' `tile` (the JAX contract's rows per block; the
    CUDA kernels pick their own): a multiple of PACKED_ROWS, at most
    PACKED_MAX_TILE; anything else raises."""
    if (not isinstance(tile, int) or tile <= 0 or tile > PACKED_MAX_TILE
            or tile % PACKED_ROWS):
        raise ValueError(f"tile={tile!r}: the packed kernel takes a multiple "
                         f"of {PACKED_ROWS} up to {PACKED_MAX_TILE}")
    return tile


def _packed_shapes(flat, B, pts, zs):
    C = flat.shape[0]
    N = pts.shape[0]
    return C, N, {"pts": (pts, (N, 3 * C)), "params": (flat, (C, CN_P)),
                  "B": (B, (C, N_DIRS, 3)),
                  **{k: (z, (N, 32 * C)) for k, z in zip(_Z_NAMES, zs)}}


def codenerf_packed_fwd_cuda(flat, B, pts, zs, inv_scale, tile):
    """csrc/codenerf_fwd.cu `cn2_fwd`: the tiled chain kernel at the
    point-major layout, one launch. `tile` is validated (check_tile) as the
    JAX contract's argument; the tiled kernel picks its own row tile
    (`cn_fwd_rows`)."""
    check_tile(tile)
    lib = _lib("codenerf_fwd")
    C, N, shapes = _packed_shapes(flat, B, pts, zs)
    _check(pts.device, shapes, aligned=("params", *_Z_NAMES))
    dev = pts.device
    sg = torch.empty(N, C, device=dev, dtype=torch.float32)
    col = torch.empty(N, 3 * C, device=dev, dtype=torch.float32)
    if N == 0:
        return sg, col
    err = lib.cn2_fwd(_ptr(pts), *(_ptr(z) for z in zs), _ptr(flat), _ptr(B),
                      _ptr(sg), _ptr(col), C, N, inv_scale, _stream(dev))
    _raise_on(err, "cn2_fwd")
    LAUNCHES["codenerf_packed_fwd"] += 1
    return sg, col


def codenerf_packed_bwd_cuda(flat, B, pts, zs, dsg, dcol, inv_scale, tile):
    """csrc/codenerf_packed.cu `cn2_bwd`: the tiled backward (64 rows of one
    category a block, one partial row of weight gradients a block), then
    `reduce_tiles`. `tile` is validated (check_tile) as the JAX contract's
    argument; the kernel's rows a block are PACKED_BLOCK_ROWS."""
    check_tile(tile)
    lib = _lib("codenerf_packed")
    C, N, shapes = _packed_shapes(flat, B, pts, zs)
    _check(pts.device, {**shapes, "dsg": (dsg, (N, C)),
                        "dcol": (dcol, (N, 3 * C))})
    dev = pts.device
    dpts = torch.empty_like(pts)
    dzs = [torch.empty_like(z) for z in zs]
    grads = torch.empty(C, CN_P + B2_SIZE, device=dev, dtype=torch.float32)
    if N == 0:
        grads.zero_()
    else:
        nt = -(-N // PACKED_BLOCK_ROWS)
        partial = torch.empty(C, nt, CN_P + B2_SIZE, device=dev,
                              dtype=torch.float32)
        err = lib.cn2_bwd(_ptr(pts), *(_ptr(z) for z in zs), _ptr(flat),
                          _ptr(B), _ptr(dsg), _ptr(dcol), _ptr(dpts),
                          *(_ptr(z) for z in dzs), _ptr(partial), _ptr(grads),
                          C, N, inv_scale, _stream(dev))
        _raise_on(err, "cn2_bwd")
        LAUNCHES["codenerf_packed_bwd"] += 1
    return (grads[:, :CN_P], grads[:, CN_P:].reshape(C, 3, N_SLOTS), dpts,
            tuple(dzs))


def cn2_tile_dx_cuda(piece, d, w, a=None, d1=None, w1=None, acc=None):
    """csrc/codenerf_packed.cu `cn2_tile_dx`: one input-gradient piece of
    the tiled backward alone (tile_dx_plain's contract without leading
    dims), through the backward's own code for it; a test entry. Every
    tensor float32, contiguous, on one CUDA device."""
    index, _, _, kout, kin, epi = packed_dx_spec(piece)
    N = d.shape[0]
    need = {"mask": ("a",), "grad_mask": ("a",), "outer": ("d1", "w1"),
            "accumulate": ("acc",), "store": ()}[epi]
    given = {"a": a, "d1": d1, "w1": w1, "acc": acc}
    if {k for k, v in given.items() if v is not None} != set(need):
        raise ValueError(f"cn2_tile_dx: {piece} ({epi}) takes "
                         f"{need or 'no extra input'}")
    want = {"a": (N, kout), "d1": (N, 1), "w1": (kout, 1),
            "acc": (N, kout)}
    shapes = {"d": (d, (N, kin)), "w": (w, (kout, kin)),
              **{k: (given[k], want[k]) for k in need}}
    _check(d.device, shapes, aligned=())
    lib = _lib("codenerf_packed")
    y = torch.empty(N, kout, device=d.device, dtype=torch.float32)
    dz = torch.empty_like(y) if epi == "grad_mask" else None
    if N == 0:
        return y, dz
    ptr = lambda x: 0 if x is None else _ptr(x)
    err = lib.cn2_tile_dx(index, _ptr(d), _ptr(w), ptr(a), ptr(d1), ptr(w1),
                          ptr(acc), _ptr(y), ptr(dz), N, _stream(d.device))
    _raise_on(err, "cn2_tile_dx")
    LAUNCHES["cn2_dx"] += 1
    return y, dz


def cn2_tile_wgrad_cuda(layer, x, d):
    """csrc/codenerf_packed.cu `cn2_tile_wgrad`: one weight gradient of the
    tiled backward alone (tile_wgrad_plain's contract without leading
    dims): one partial a 64-row block, then `reduce_tiles`; a test entry.
    x [N, K], d [N, OUT], float32, contiguous, on one CUDA device."""
    index, pieces, out, bias = packed_wgrad_spec(layer)
    N, K = x.shape[0], sum(pieces)
    _check(x.device, {"x": (x, (N, K)), "d": (d, (N, out))}, aligned=())
    lib = _lib("codenerf_packed")
    pp = K * out + (out if bias else 0)
    res = torch.zeros(pp, device=x.device, dtype=torch.float32)
    if N > 0:
        partial = torch.empty(-(-N // PACKED_BLOCK_ROWS), pp,
                              device=x.device, dtype=torch.float32)
        err = lib.cn2_tile_wgrad(index, _ptr(x), _ptr(d), _ptr(partial),
                                 _ptr(res), N, _stream(x.device))
        _raise_on(err, "cn2_tile_wgrad")
        LAUNCHES["cn2_wgrad"] += 1
    return res[:K * out].reshape(K, out), res[K * out:] if bias else None


def cn_cos_cuda(x):
    """csrc/codenerf_packed.cu `cn_cos`: the packed backward's cosine
    (`cos_f32`, sin_f32's reduction with the quadrant moved by one, nothing
    in local memory) alone; a test entry."""
    _check(x.device, {"x": (x, tuple(x.shape))}, aligned=())
    lib = _lib("codenerf_packed")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _raise_on(lib.cn_cos(_ptr(x), _ptr(y), x.numel(), _stream(x.device)),
              "cn_cos")
    LAUNCHES["cn_cos"] += 1
    return y


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises (the plain version is taken only for CPU tensors)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_field: unsupported device {x.device}")
    return x.device.type == "cuda"


def codenerf_fwd(flat, B, pts, zs, inv_scale):
    if _on_cuda(pts):
        return codenerf_fwd_cuda(flat, B, pts, zs, inv_scale)
    return codenerf_fwd_plain(flat, B, pts, zs, inv_scale)


def codenerf_bwd(flat, B, pts, zs, dout, inv_scale):
    if _on_cuda(pts):
        return codenerf_bwd_cuda(flat, B, pts, zs, dout, inv_scale)
    return codenerf_bwd_plain(flat, B, pts, zs, dout, inv_scale)


def occupancy_fwd(flat, B, pts, inv_scale):
    if _on_cuda(pts):
        return occupancy_fwd_cuda(flat, B, pts, inv_scale)
    return occupancy_fwd_plain(flat, B, pts, inv_scale)


def occupancy_bwd(flat, B, pts, dout, inv_scale):
    if _on_cuda(pts):
        return occupancy_bwd_cuda(flat, B, pts, dout, inv_scale)
    return occupancy_bwd_plain(flat, B, pts, dout, inv_scale)


def oc_gemm(layout, epilogue, a, b, c, bias=None, mask=None, u=None,
            v=None):
    """The background chain's 128-wide GEMM block alone (gemm_plain)."""
    if _on_cuda(c):
        return oc_gemm_cuda(layout, epilogue, a, b, c, bias, mask, u, v)
    return gemm_plain(layout, epilogue, a, b, c, bias, mask, u, v)


def cn_gemm(layout, epilogue, a, b, c, bias=None, mask=None, z=None,
            c2=None):
    """The CodeNeRF backward's 32-wide GEMM block alone, batched over the
    categories (gemm_plain, with no rank-1 term)."""
    if _on_cuda(c):
        return cn_gemm_cuda(layout, epilogue, a, b, c, bias, mask, z, c2)
    return gemm_plain(layout, epilogue, a, b, c, bias, mask, z=z, c2=c2)


def codenerf_packed_fwd(flat, B, pts, zs, inv_scale, tile):
    if _on_cuda(pts):
        return codenerf_packed_fwd_cuda(flat, B, pts, zs, inv_scale, tile)
    return codenerf_packed_fwd_plain(flat, B, pts, zs, inv_scale)


def codenerf_packed_bwd(flat, B, pts, zs, dsg, dcol, inv_scale, tile):
    if _on_cuda(pts):
        return codenerf_packed_bwd_cuda(flat, B, pts, zs, dsg, dcol,
                                        inv_scale, tile)
    return codenerf_packed_bwd_plain(flat, B, pts, zs, dsg, dcol, inv_scale)


def cn_tile_layer(layer, x, w, bias, z=None):
    """One layer of the forward chain kernel alone (tile_layer_plain)."""
    if _on_cuda(x):
        return cn_tile_layer_cuda(layer, x, w, bias, z)
    return tile_layer_plain(layer, x, w, bias, z)


def cn_sin(x):
    """The forward chain kernel's sine alone; its plain version is
    torch.sin."""
    if _on_cuda(x):
        return cn_sin_cuda(x)
    return torch.sin(x)


def cn2_tile_dx(piece, d, w, a=None, d1=None, w1=None, acc=None):
    """One input-gradient piece of the packed backward alone
    (tile_dx_plain)."""
    if _on_cuda(d):
        return cn2_tile_dx_cuda(piece, d, w, a, d1, w1, acc)
    return tile_dx_plain(piece, d, w, a, d1, w1, acc)


def cn2_tile_wgrad(layer, x, d):
    """One weight gradient of the packed backward alone
    (tile_wgrad_plain)."""
    if _on_cuda(x):
        return cn2_tile_wgrad_cuda(layer, x, d)
    return tile_wgrad_plain(layer, x, d)


def cn_cos(x):
    """The packed backward's cosine alone; its plain version is
    torch.cos."""
    if _on_cuda(x):
        return cn_cos_cuda(x)
    return torch.cos(x)


def cn_emb_load(emb1, emb2):
    """The MLP-only kernel's load of its embedding alone
    (emb_load_plain)."""
    if _on_cuda(emb1):
        return cn_emb_load_cuda(emb1, emb2)
    return emb_load_plain(emb1, emb2)


def codenerf_mlp_fwd(flat, emb1, emb2, zs):
    """Kernel 7: the CodeNeRF chain on a precomputed embedding, forward
    only. flat [C, P] (`pack`), emb1 [C, N, 87], emb2 [C, N, 42], zs 4x
    [C, N, 32] -> out [C, N, 4] = [sigma x10 | rgb]."""
    if _on_cuda(emb1):
        return codenerf_mlp_fwd_cuda(flat, emb1, emb2, zs)
    return codenerf_mlp_fwd_plain(flat, emb1, emb2, zs)


class _CodeNeRFFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, B, pts, zs0, zc, zs1, zt0, inv_scale):
        ctx.inv_scale = inv_scale
        ctx.save_for_backward(flat, B, pts, zs0, zc, zs1, zt0)
        return codenerf_fwd(flat, B, pts, (zs0, zc, zs1, zt0), inv_scale)

    @staticmethod
    def backward(ctx, dout):
        flat, B, pts, *zs = ctx.saved_tensors
        dflat, dB, dpts, dzs = codenerf_bwd(flat, B, pts, zs,
                                            dout.contiguous(), ctx.inv_scale)
        return (dflat, dB, dpts, *dzs, None)


class _OccupancyFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, B, pts, inv_scale):
        ctx.inv_scale = inv_scale
        ctx.save_for_backward(flat, B, pts)
        return occupancy_fwd(flat, B, pts, inv_scale)

    @staticmethod
    def backward(ctx, dout):
        flat, B, pts = ctx.saved_tensors
        dflat, dB, dpts = occupancy_bwd(flat, B, pts, dout.contiguous(),
                                        ctx.inv_scale)
        return dflat, dB, dpts, None


def codenerf_fused_apply(fc, pe, pts, zs0, zc, zs1, zt0, *, scale: float):
    """Fused category-ensemble forward (ref: codenerf_fused_apply :384).

    fc: the stacked CodeNeRF (models/codenerf.py); pe: its stacked basis
    (pe.B [C, 21, 3]); pts: [C, N, 3] object-frame sample points;
    zs0/zc/zs1/zt0: [C, N, 32] pre-broadcast ReLU'd latent injections.
    Returns (sigma [C, N], rgb [C, N, 3]); differentiable w.r.t. the
    field's layers, the basis, the points and the injections (the latent
    layers get their gradients through the injections)."""
    flat = pack(_cn_modules(fc))
    out = _CodeNeRFFused.apply(flat, pe.B.contiguous(), pts.contiguous(),
                               zs0.contiguous(), zc.contiguous(),
                               zs1.contiguous(), zt0.contiguous(),
                               1.0 / float(scale))
    return out[..., 0], out[..., 1:4]


def occupancy_fused_apply(fc, pe, pts, *, scale: float):
    """Fused background forward (ref: occupancy_fused_apply :631):
    pts [N, 3] -> (alpha [N], rgb [N, 3]); hidden=128, one block."""
    flat = pack(_oc_modules(fc))
    out = _OccupancyFused.apply(flat, pe.B.contiguous(), pts.contiguous(),
                                1.0 / float(scale))
    return out[..., 0], out[..., 1:4]


class _CodeNeRFPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, B, pts, zs0, zc, zs1, zt0, inv_scale, tile):
        ctx.inv_scale, ctx.tile = inv_scale, tile
        ctx.save_for_backward(flat, B, pts, zs0, zc, zs1, zt0)
        return codenerf_packed_fwd(flat, B, pts, (zs0, zc, zs1, zt0),
                                   inv_scale, tile)

    @staticmethod
    def backward(ctx, dsg, dcol):
        flat, B, pts, *zs = ctx.saved_tensors
        dflat, dB2, dpts, dzs = codenerf_packed_bwd(
            flat, B, pts, zs, dsg.contiguous(), dcol.contiguous(),
            ctx.inv_scale, ctx.tile)
        return (dflat, unfold_db2(dB2), dpts, *dzs, None, None)


def codenerf_packed_apply(fc, pe, pts_packed, zs0, zc, zs1, zt0, *,
                          scale: float, tile: int = 256):
    """Packed-ensemble forward (ref: codenerf_packed_apply :958-977).

    pts_packed [N, 3C] (point-major, categories in lanes); z* [N, 32C].
    Returns (sigma [N, C], rgb [N, C, 3]); differentiable w.r.t. the field's
    layers, pe.B, the points and the injections. `tile` is the JAX
    contract's rows per block (check_tile); the CUDA kernels pick their
    own."""
    check_tile(tile)
    flat = pack(_cn_modules(fc))
    C = flat.shape[0]
    N = pts_packed.shape[0]
    if pts_packed.shape[-1] != 3 * C:
        raise ValueError(f"pts_packed: {tuple(pts_packed.shape)} is not "
                         f"[N, 3C] for C={C}")
    sg, col = _CodeNeRFPacked.apply(
        flat, pe.B.contiguous(), pts_packed.contiguous(), zs0.contiguous(),
        zc.contiguous(), zs1.contiguous(), zt0.contiguous(),
        1.0 / float(scale), tile)
    return sg, col.reshape(N, C, 3)
