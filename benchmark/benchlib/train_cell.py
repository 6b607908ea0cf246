"""The training endpoint: the program's graphed fast path,
`TrainingSession.run_fast`, on a scene, weights and draws made from the
seed.

Set-up builds one session and drives it through its first steps, which
the reference follows: steps 1-3 are the captured step's eager warm-up
(the graph is captured after step 3), steps 4-6 its first replays. The
same session then runs the window: calls of `n_inner` steps, each step's
window offsets and sampling uniforms made by the benchmark on the device
and handed to `run_fast`, as the check's steps were. Once the window has
closed and the memory peak is read, the session is freed and the
reference follows the six steps from the same weights on the rows the
store holds at the same offsets.
"""

from __future__ import annotations

import gc
import time

import torch

from benchlib import compare, reference, scene, trace, work

CHECK_STEPS = 6
BETA1 = 0.9


def program_config(cell, seed: int):
    """The program's Config of the cell: the configuration file as the
    CLI's --config reads it, the scene's assumed intrinsics, the traffic's
    trainer flags and the seed."""
    from catnerf_torch.config import Config

    cfg = Config.from_reference_dict(cell.config_raw)
    intr = cell.config_raw["benchmark"]["scene"].get("intrinsics")
    if intr is not None:
        cfg.fx, cfg.fy, cfg.cx, cfg.cy = (intr[k] for k in
                                          ("fx", "fy", "cx", "cy"))
    trainer = cell.traffic_params["trainer"]
    cfg.use_fused_kernels = bool(trainer["use_fused_kernels"])
    cfg.bf16_activations = bool(trainer["bf16_activations"])
    cfg.seed = seed
    return cfg


def reference_config(raw: dict) -> dict:
    """The reference's constants, read from the configuration file."""
    r, m, o = raw["render"], raw["model"], raw["optimizer"]["args"]
    return {"min_depth": float(r["depth_range"][0]), "n_bins": r["n_bins"],
            "n_c2s": r["n_bins_cam2surface"],
            "n_c2s_bg": r["n_bins_cam2surface_bg"],
            "n_per_optim": r["n_per_optim"], "n_bg": r["n_per_optim_bg"],
            "surface_eps": m["surface_eps"], "stop_eps": m["other_eps"],
            "obj_scale": m["obj_scale"], "bg_scale": m["bg_scale"],
            "color_scaling": m["color_scaling"],
            "opacity_scaling": m["opacity_scaling"],
            "lr": o["lr"], "wd": o["weight_decay"], "code_lr": o["code_lr"],
            "code_wd": o["code_weight_decay"]}


def camera(raw: dict) -> scene.Camera:
    """The frame's camera: the configuration's, cropped by its margins."""
    c = raw["camera"]
    intr = raw["benchmark"]["scene"].get("intrinsics", c)
    mw, mh = c.get("mw", 0), c.get("mh", 0)
    return scene.Camera(c["w"] - 2 * mw, c["h"] - 2 * mh, intr["fx"],
                        intr["fy"], intr["cx"] - mw, intr["cy"] - mh)


def architecture(raw: dict, inst_dict: dict) -> dict:
    """The reference's sizes: the configuration's widths, the scene's
    categories and instances."""
    nh = raw["model"]["net_hyperparams"]
    counts = [len(v) for k, v in inst_dict.items() if k != 0]
    return {"n_cls": len(counts), "n_obj": max(counts), "W": nh["W"],
            "latent": nh["latent_dim"], "shape_blocks": nh["shape_blocks"],
            "texture_blocks": nh["texture_blocks"],
            "bg_hidden": raw["model"]["hidden_feature_size_bg"]}


def write_weights(sess, w0: dict) -> None:
    """The benchmark's weights into the program's parameters, by name."""
    params = dict(sess.state.params.named_parameters())
    if set(params) != set(w0):
        raise RuntimeError("the program's parameters are not the reference's"
                           f": {sorted(set(params) ^ set(w0))}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(w0[k])


def n_uniforms(n_c2s: int, n_bins: int) -> int:
    """Uniforms a ray's sampling reads: n_c2s + n_bins stratified for a
    ray without depth, n_c2s before the surface, n_bins + 1 for the
    sorted normal band and n_bins for the stratified band."""
    return (n_c2s + n_bins) + n_c2s + (n_bins + 1) + n_bins


class Draws:
    """Each step's window offsets and sampling uniforms, made on the device
    from the seed: an offset uniform in each category's rows and in the
    background's, and uniforms in [0, 1)."""

    def __init__(self, seed: int, lengths: list[int], bg_length: int,
                 rays: int, rays_bg: int, rcfg: dict, device):
        self.gen = torch.Generator(device).manual_seed(seed)
        self.lengths = torch.tensor(lengths, dtype=torch.float64,
                                    device=device)
        self.bg_length = bg_length
        self.shape = (len(lengths), rays,
                      n_uniforms(rcfg["n_c2s"], rcfg["n_bins"]))
        self.shape_bg = (rays_bg, n_uniforms(rcfg["n_c2s_bg"], rcfg["n_bins"]))
        self.device = device

    def make(self, n: int) -> list:
        from catnerf_torch.data.device_buffer import FastDraws
        from catnerf_torch.train.step import StepDraws

        g, dev = self.gen, self.device
        u = torch.rand(n, len(self.lengths) + 1, generator=g, device=dev,
                       dtype=torch.float64)
        offs = torch.minimum((u[:, :-1] * self.lengths).long(),
                             self.lengths.long() - 1)
        boff = torch.clamp((u[:, -1] * self.bg_length).long(),
                           max=self.bg_length - 1)
        u_cat = torch.rand(n, *self.shape, generator=g, device=dev)
        u_bg = torch.rand(n, *self.shape_bg, generator=g, device=dev)
        return [FastDraws(offs[i], boff[i], StepDraws(u_cat[i], u_bg[i]))
                for i in range(n)]


def _rows(packed, lengths, offs, n):
    """Rows [off, off + n) of each buffer, cyclically: [C, n, cols]."""
    idx = (offs[:, None] + torch.arange(n, device=offs.device)) % lengths[:, None]
    return packed[torch.arange(packed.shape[0], device=offs.device)[:, None],
                  idx]


def _batch(cat_rows, bg_rows, d, n_objs):
    def cols(r, with_obj):
        out = {"origins": r[..., 0:3], "dirs": r[..., 3:6],
               "rgb": r[..., 6:9], "depth": r[..., 9],
               "state": r[..., 10].long()}
        if with_obj:
            out["obj"] = r[..., 11].long()
        return out

    return {"cat": cols(cat_rows, True), "bg": cols(bg_rows, False),
            "u_cat": d.step.cat.clone(), "u_bg": d.step.bg.clone(),
            "n_objs": n_objs}


def _norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def precision(spec: dict) -> reference.Precision:
    """A traffic file's "reference" or "control" precision."""
    storage = spec.get("storage")
    return reference.Precision(
        spec["products"], None if storage is None else getattr(torch, storage))


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> dict:
    """One run of a training cell. Returns the readings the metrics and
    the checks take. The reference computes in the precision the traffic
    states. control: the reference in the traffic's control precision
    takes the program's place as the compared side (the program still
    runs, the set-up and the window as always)."""
    from catnerf_torch.data.camera import CameraInfo
    from catnerf_torch.train.loop import TrainingSession
    from catnerf_torch.utils import phase_timings, reset_phase_timings

    raw = cell.config_raw
    tp = cell.traffic_params
    rcfg = reference_config(raw)
    cfg = program_config(cell, seed)
    cam = camera(raw)
    inst_dict, sample_dict = scene.make_scene(raw["benchmark"]["scene"], cam,
                                              seed, device)
    cls_ids = sorted(k for k in inst_dict if k != 0)
    n_objs = [len(inst_dict[c]) for c in cls_ids]
    arch = architecture(raw, inst_dict)
    rays = sum(n_objs) * rcfg["n_per_optim"] // len(cls_ids)
    lengths = [sum(int((fi["bbox"][1] - fi["bbox"][0])
                       * (fi["bbox"][3] - fi["bbox"][2]))
                   for info in inst_dict[c].values()
                   for fi in info["frame_info"]) for c in cls_ids]
    bg_length = cam.width * cam.height * len(inst_dict[0]["frame_info"])

    reset_phase_timings()
    readings: dict = {}
    t0 = time.perf_counter()
    sess = TrainingSession(cfg, inst_dict, sample_dict,
                           cam=CameraInfo(cam.width, cam.height, cam.fx,
                                          cam.fy, cam.cx, cam.cy),
                           device=device)
    readings["setup_session_s"] = time.perf_counter() - t0
    readings["session_phases"] = phase_timings("session")
    if sess.cls_ids != cls_ids:
        raise RuntimeError(f"the session trains categories {sess.cls_ids}, "
                           f"the scene has {cls_ids}")

    w0 = reference.init_weights(arch, seed, device)
    write_weights(sess, w0)
    params = dict(sess.state.params.named_parameters())

    t0 = time.perf_counter()
    sess.enable_fast_path(n_inner=tp["n_inner"])
    draws = Draws(seed + 2, lengths, bg_length, rays, rcfg["n_bg"], rcfg,
                  device)
    store = sess._store
    prog_losses, batches, states = [], [], []
    n_objs_t = torch.tensor(n_objs, device=device)
    length_t = torch.tensor(lengths, device=device)
    for step in range(1, CHECK_STEPS + 1):
        d = draws.make(1)
        batches.append(_batch(
            _rows(store.packed, length_t, d[0].offs, rays),
            _rows(store.bg_packed[None], torch.tensor([bg_length],
                                                      device=device),
                  d[0].boff[None], rcfg["n_bg"])[0], d[0], n_objs_t))
        states.append({k: p.detach().clone() for k, p in params.items()})
        m = sess.run_fast(1, draws=d)
        prog_losses.append(m.total)
        if step == 1:
            opt = sess.state.optimizer
            # a parameter the optimizer holds no moment of got nothing
            readings["prog_grad1"] = _norms(
                {k: opt.state[p]["exp_avg"] / (1.0 - BETA1)
                 if "exp_avg" in opt.state.get(p, {}) else
                 torch.zeros_like(p) for k, p in params.items()})
        if step in (3, 6):
            readings[f"prog_delta{step}"] = _norms(
                {k: p.detach() - w0[k] for k, p in params.items()})
        if step == 3:
            sync(device)
            readings["setup_fast_path_s"] = time.perf_counter() - t0
    readings["prog_losses"] = [float(x) for x in prog_losses]
    readings["fast_path_phases"] = phase_timings("fast_path")
    sync(device)
    readings["setup_s"] = time.perf_counter() - t_start

    # the window
    n_inner = tp["n_inner"]
    if traced:
        readings["trace"] = _traced_window(sess, draws, n_inner, device)
        readings["steps"] = readings["trace"].steps if readings["trace"] else 0
    else:
        steps, window_s = _window(sess, draws, n_inner, seconds, device)
        readings["steps"], readings["window_s"] = steps, window_s
    readings["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else 0)

    # the program's store against the scene, then the program freed
    ref_cats, ref_bg = reference.ray_sets(inst_dict, sample_dict, cam,
                                          cls_ids, device)
    values = {"store_rows": float(
        sum(int(a.shape[0] != n) for a, n in zip(ref_cats, lengths))
        + int(ref_bg.shape[0] != bg_length)
        + sum(int(n != int(m)) for n, m in zip(lengths, store.lengths))
        + int(bg_length != store.bg_length))}
    if values["store_rows"] == 0:
        gaps = [reference.fingerprint_gap(
            reference.fingerprint(store.packed[i, :n]),
            reference.fingerprint(ref_cats[i])) for i, n in enumerate(lengths)]
        gaps.append(reference.fingerprint_gap(
            reference.fingerprint(store.bg_packed[:bg_length]),
            reference.fingerprint(ref_bg)))
        values["store_gap"] = max(gaps)
    del ref_cats, ref_bg, store, params, sess, m, opt, draws
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the six steps from the benchmark's weights, and
    # takes each step's loss at the program's weights before it
    t0 = time.perf_counter()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_p = precision(tp["reference"])
    try:
        ref_losses, ref_g1, ref_after = reference.run_steps(
            w0, batches, arch, rcfg, ref_p)
        ref_step = reference.losses_at(states[1:], batches[1:], arch, rcfg,
                                       ref_p)
        if control:
            ctl_p = precision(tp["control"])
            o_losses, o_g1, o_after = reference.run_steps(
                w0, batches, arch, rcfg, ctl_p)
            readings["prog_losses"] = (o_losses[:1] + reference.losses_at(
                states[1:], batches[1:], arch, rcfg, ctl_p))
            readings["prog_grad1"] = _norms(o_g1)
            for k in (3, 6):
                readings[f"prog_delta{k}"] = _norms(
                    {n: o_after[k - 1][n] - w0[n] for n in w0})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    readings["reference_s"] = time.perf_counter() - t0
    g1_ref = _norms(ref_g1)
    moved = compare.moved_leaves(g1_ref)
    prog = readings["prog_losses"]
    values["loss1_gap"] = compare.loss_gap(prog[:1], ref_losses[:1])
    values["step_loss_gap"] = compare.loss_gap(prog[1:], ref_step)
    values["grad1_gap"] = compare.worst_leaf(readings["prog_grad1"], g1_ref)
    for k, gap in ((3, compare.worst_leaf), (6, compare.median_leaf)):
        values[f"delta{k}_gap"] = gap(
            readings[f"prog_delta{k}"],
            _norms({n: ref_after[k - 1][n] - w0[n] for n in w0}), moved)
    readings["chained_loss_gaps"] = [abs(a - b) / abs(b) for a, b in
                                     zip(prog, ref_losses)]
    readings["ref_losses"] = ref_losses
    readings["values"] = values
    readings["unmoved_leaves"] = sorted(set(w0) - set(moved))
    readings["work"] = work.step_work(cfg, n_objs, rays)
    if not traced:
        readings["end_to_end"] = {
            "setup_s": readings["setup_s"],
            "train_samples_per_s": readings["steps"] * readings["work"].samples
            / readings["window_s"]}
    readings["failed"] = 0
    return readings


def _window(sess, draws: Draws, n_inner: int, seconds: float, device):
    """Calls of n_inner steps until `seconds` have passed on the host
    clock, at most one call queued behind the one running; the window
    ends when the device has finished the last. Returns (steps, s)."""
    cuda = device.type == "cuda"
    sync(device)
    t0 = time.perf_counter()
    steps, pending = 0, []
    while True:
        sess.run_fast(n_inner, draws=draws.make(n_inner))
        steps += n_inner
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 1:
                pending.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return steps, time.perf_counter() - t0


def _traced_window(sess, draws: Draws, n_inner: int, device):
    """One call of n_inner steps under the profiler, after one untraced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sess.run_fast(n_inner, draws=draws.make(n_inner))
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            sess.run_fast(n_inner, draws=draws.make(n_inner))
            sync(device)
    return trace.reduce_profile(prof, n_inner)
