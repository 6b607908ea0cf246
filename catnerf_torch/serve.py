"""Minimal HTTP serving layer for trained scenes.

The port's counterpart of the JAX package's `serve.py`. Serves novel-view
renders of a trained checkpoint over HTTP — the deployment surface the
reference lacks entirely (its only outputs are offline mesh files, ref:
src/trainer.py:62-123, train.py:214-243). The server is threaded, but
device work (renders, mesh extraction, ingest) serializes on one lock —
one device, one session — while /health stays lock-free and responsive. Every
render runs on the session's device (render_views.py), under
`torch.inference_mode()` taken by the render itself: grad mode is per
thread in PyTorch, and the handler threads take none of their own.

Requested w/h/bins snap to a whitelist (160x120..1280x960; 16..192 bins),
as in the JAX package, where each distinct shape compiles one program;
here it bounds the cached ray grids and a request's device memory.

Endpoints (all GET, images as PNG):
  /  (or /viewer)                  -> built-in browser viewer: orbit
                                      sliders driving /object and /scene
                                      (inline HTML/JS, no external assets)
  /health                          -> {"ok": true, "objects": [...]}
  /object?id=<obj_id>&az=<deg>&el=<deg>[&radius=R][&w=W&h=H][&bins=B]
                                   -> orbit render of one object
  /scene?frame=<idx>[&w=W&h=H][&bins=B]
                                   -> composited whole-scene render from a
                                      dataset pose
  /scene?az=<deg>&el=<deg>&radius=R[&cx=&cy=&cz=]
                                   -> composited render from a free camera
                                      orbiting the scene center
  /edit?id=<obj_id>[&shape_from=B][&texture_from=B][&interp=B&t=0.5]
       [&mean=1][orbit params]     -> live latent-code edit of one object
                                      (swap/interp/category-prior codes)
  /mesh?id=<obj_id>                -> scene-frame colored .obj extracted
                                      live from the field (0 = background;
                                      cached per state version)

POST /ingest?cls=<cls_id>[&id=N][&steps=600][&rays=360][&accumulate=direct|tsdf]
            [&save=0]
  Body: an .npz with rgb [n,W,H,3] u8, depth [n,W,H] f32 (meters), mask
  [n,W,H] (>0 this instance, 0 other, <0 unknown), T_wc [n,4,4] — the
  repo's transposed (W,H) layout at the session camera's resolution.
  Runs the full new-scan workflow (fit.ingest_new_instance): unproject ->
  register to the category's canonical union -> fit codes + pose against
  the frozen MLP on the session's device -> adopt into the live session.
  Returns the summary JSON; the new id serves immediately via /object,
  /edit, /mesh and /scene. With a checkpoint directory (the CLI's
  <logdir>/ckpt) the adoption is persisted as a new checkpoint iteration
  + adopted-sidecar (survives a server restart) unless save=0.

CLI: python -m catnerf_torch.serve --logdir <dir> [--synthetic | --config
<json>] [--port 8765] [--device cpu]

Sharded (the JAX package's --sharded): torchrun --nproc-per-node N -m
catnerf_torch.serve --sharded ... Every rank restores the whole session.
Rank 0 serves HTTP; the others follow (`follow`): each /scene and each
uncached /mesh runs over every rank (`render_scene_view` and `mesh_object`
with the ('data', 'model') mesh, identical pixels and bytes), and so does
the adoption step of /ingest (rank 0 registers, fits and saves alone).
/object, /edit and /health stay on rank 0.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import sys
import threading
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)
from urllib.parse import parse_qs, urlparse

import numpy as np

from catnerf_torch import tracing
from catnerf_torch.data import png
from catnerf_torch.parallel import mesh as pmesh
from catnerf_torch.render_views import (
    add_scene_args,
    default_orbit_cam,
    instance_frame,
    instance_mask_box,
    look_at,
    orbit_eye,
    orbit_frame,
    render_scene_view,
    render_view,
    restore_session,
    scene_far,
)

def _png(img: np.ndarray) -> bytes:
    """(W, H, 3) float [0,1] -> PNG bytes (standard row-major layout); the
    span serve.png."""
    with tracing.span("serve.png"):
        bgr = (np.clip(img, 0, 1).transpose(1, 0, 2) * 255).astype(
            np.uint8)[..., ::-1]
        return png.imencode(bgr)


#: how long a follower waits for the next request: an idle server must
#: not die at the process group's default timeout (30 minutes)
IDLE_TIMEOUT = datetime.timedelta(days=365)
#: the calls a follower makes when rank 0 broadcasts them, and the stop
_FOLLOWED = ("_scene", "_mesh", "_adopt")
_STOP = "stop"


class SceneServer:
    """Render dispatch for one trained session. Device work (renders,
    mesh extraction, ingest) serializes on self.lock — one device, one
    session — while metadata reads (/health) stay lock-free, so a long
    ingest never blocks a liveness probe. The handler takes the lock;
    calling methods directly (tests, warmup) needs none.

    device_mesh: a DeviceMesh of more than one process (every rank builds
    its SceneServer with it, on the whole session) makes a sharded server:
    rank 0 serves (serve_sharded), the others `follow`."""

    def __init__(self, session, ckpt_dir: str | None = None,
                 device_mesh=None):
        self.session = session
        self.cfg = session.cfg
        # when set, /ingest persists the adopted session as a NEW
        # checkpoint iteration here (adoptees then survive a restart)
        self.ckpt_dir = ckpt_dir
        # /mesh results keyed by (obj_id, state version): extraction costs
        # seconds, the fields only change on training or adoption (serving
        # never trains)
        self._mesh_cache: dict = {}
        # serializes device work across handler threads (see class doc)
        self.lock = threading.RLock()
        self.device_mesh = (device_mesh if device_mesh is not None
                            and device_mesh.size() > 1 else None)
        self._stopped = False
        # the group rank 0 broadcasts each call on (made here, where every
        # rank builds its server). Hazard, an idle server: a follower waits
        # on it for the next request, so its timeout outlives any pause
        self._group = (pmesh.new_cpu_group(IDLE_TIMEOUT)
                       if self.device_mesh is not None else None)

    def _on_every_rank(self, op: str, *args):
        """self.<op>(*args), and on a sharded server the same call on
        every follower, which rank 0 broadcasts first. Hazards, handled
        by the callers: broadcast under the lock (the handler holds
        self.lock, so the followers see the calls in rank 0's order), and
        validate before broadcasting (an exception on one rank inside a
        collective hangs the others: a request that would raise is
        rejected before this)."""
        if self.device_mesh is not None:
            if self._stopped:
                raise RuntimeError("the server is stopping")
            pmesh.broadcast_object((op, args), group=self._group)
        return getattr(self, op)(*args)

    def stop(self) -> None:
        """Rank 0 of a sharded server: broadcast the stop, after the
        request in flight (under the lock); every follower then returns.
        A later request that would broadcast raises."""
        with self.lock:
            if self.device_mesh is not None and not self._stopped:
                pmesh.broadcast_object((_STOP, ()), group=self._group)
            self._stopped = True

    @property
    def _objects(self):
        # computed per access (cheap: a few dozen entries) so instances
        # adopted into the live session (fit.adopt_instance) serve
        # immediately without recreating the server
        return {int(obj_id): (cls_id, cat)
                for cls_id, cat in zip(self.session.cls_ids,
                                       self.session.categories)
                for obj_id in cat.obj_ids}

    def object_ids(self) -> list[int]:
        return sorted(self._objects)

    def _orbit_render(self, params, sc, tc, extent, center, mask, az_deg,
                      el_deg, radius, width, height, n_bins) -> np.ndarray:
        """Shared framing/camera/render tail of /object and /edit — one
        place for the orbit recipe so the two endpoints cannot diverge.
        mask: instance_mask_box result (occupancy zeroed outside the
        object's box, where the field is untrained)."""
        r, near, far = orbit_frame(extent, radius)
        T = look_at(orbit_eye(np.deg2rad(az_deg), np.deg2rad(el_deg),
                              r, center), center)
        cam = default_orbit_cam(width, height)
        img, _, _ = render_view(params, self.cfg, T, cam, near=near, far=far,
                                shape_code=sc, texture_code=tc,
                                n_bins=n_bins, mask_box=mask)
        return img

    def render_object(self, obj_id: int, az_deg: float, el_deg: float,
                      radius: float | None, width: int, height: int,
                      n_bins: int) -> np.ndarray:
        cls_id, cat = self._objects[obj_id]
        params = self.session.category_params(cls_id)
        k = cat.inst_id_to_index[obj_id]
        sc = params["shape_codes"][k]
        tc = params["texture_codes"][k]
        fr = instance_frame(self.session, cls_id, [obj_id])
        if fr is None:  # degenerate hull at dataset build
            raise ValueError(f"object {obj_id} has no bound; "
                             "cannot frame an orbit camera")
        extent, center = fr
        mask = instance_mask_box(self.session, cls_id, [obj_id])
        return self._orbit_render(params, sc, tc, extent, center, mask,
                                  az_deg, el_deg, radius, width, height,
                                  n_bins)

    def render_object_edit(self, obj_id: int, az_deg: float, el_deg: float,
                           radius: float | None, width: int, height: int,
                           n_bins: int, *, shape_from: int | None = None,
                           texture_from: int | None = None,
                           interp: int | None = None, t: float = 0.5,
                           mean: bool = False) -> np.ndarray:
        """Live latent-code editing (catnerf_torch/edit.py) over HTTP: the
        edited codes are plain inputs of the render, so an edit request
        costs the same as a normal /object render."""
        from catnerf_torch import edit as edit_mod

        cls_id, cat = self._objects[obj_id]
        if mean:
            sc, tc = edit_mod.mean_codes(self.session, cls_id)
            donors = list(cat.obj_ids)
        elif interp is not None:
            sc, tc = edit_mod.interpolate_codes(self.session, cls_id,
                                                obj_id, interp, t)
            donors = [interp]
        else:
            if shape_from is None and texture_from is None:
                raise ValueError("give shape_from, texture_from, interp, "
                                 "or mean=1")
            sc, tc = edit_mod.edit_codes(self.session, cls_id, obj_id,
                                         shape_from=shape_from,
                                         texture_from=texture_from)
            donors = [x for x in (shape_from, texture_from)
                      if x is not None]
        extent, center = edit_mod._edit_frame(self.session, cls_id,
                                              [obj_id] + donors)
        mask = instance_mask_box(self.session, cls_id, [obj_id] + donors)
        params = self.session.category_params(cls_id)
        return self._orbit_render(params, sc, tc, extent, center, mask,
                                  az_deg, el_deg, radius, width, height,
                                  n_bins)

    def ingest(self, body: bytes, q: dict) -> dict:
        """POST /ingest — decode the .npz observation payload and run the
        register->fit->adopt workflow (fit.ingest_new_instance). Serial like
        every other handler: the fit runs on the same device the renders
        use, so a long ingest delays (never corrupts) concurrent reads."""
        from catnerf_torch import fit as fit_mod

        try:
            payload = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            raise ValueError(f"body is not a readable .npz: {e!r}") from e
        missing = [k for k in ("rgb", "depth", "mask", "T_wc")
                   if k not in payload]
        if missing:
            raise ValueError(f".npz payload missing arrays: {missing}")
        # a sharded server registers and fits on rank 0 alone (the session
        # is whole there), then adopts on every rank
        out = fit_mod.ingest_new_instance(
            self.session, int(q["cls"]),
            payload["rgb"], payload["depth"], payload["mask"],
            payload["T_wc"],
            inst_id=int(q["id"]) if "id" in q else None,
            steps=int(q.get("steps", 600)),
            n_rays=int(q.get("rays", 360)),
            accumulate=q.get("accumulate", "direct"),
            adopt=(True if self.device_mesh is None else
                   lambda *fitted: self._on_every_rank("_adopt", *fitted)))
        # persist the adoption (save=0 opts out): a NEW checkpoint
        # iteration + adopted-sidecar, so a restarted server (which
        # restores via restore_session_checkpoint) still has the instance
        if self.ckpt_dir is not None and q.get("save", "1") != "0":
            from catnerf_torch.train.checkpoint import (
                latest_checkpoint, save_session_checkpoint)

            latest = latest_checkpoint(self.ckpt_dir)
            it = (int(os.path.basename(latest)) if latest else 0) + 1
            out["checkpoint"] = save_session_checkpoint(
                self.ckpt_dir, self.session, it)
        return out

    def _adopt(self, cls_id: int, inst_id: int, result) -> None:
        from catnerf_torch import fit as fit_mod

        fit_mod.adopt_instance(self.session, cls_id, inst_id, result)

    def mesh_obj(self, obj_id: int) -> bytes:
        """GET /mesh — scene-frame colored .obj of one object (0 =
        background), extracted live from the field (mesher/meshing.py::
        mesh_object: adaptive grid, space carving, sim(3) scene
        transform). Cached per (object, state version) — the fields only
        change on training or adoption (/ingest), so repeat requests are
        free."""
        if obj_id != 0 and obj_id not in self._objects:
            raise ValueError(f"unknown object id {obj_id}")
        ver = (int(self.session.state.step),
               len(getattr(self.session, "adopted_instances", [])))
        key = (obj_id, ver)
        # a cache hit runs on rank 0 alone: it broadcasts nothing
        data = self._mesh_cache.get(key)
        if data is None:
            data = self._on_every_rank("_mesh", obj_id)
            # bound host memory by BYTES, not entries: a background mesh
            # at 5 mm voxels serializes to hundreds of MB. An entry larger
            # than the whole budget is returned but never cached (caching
            # it would pin > budget after the loop empties the cache).
            budget = 512 << 20
            if len(data) <= budget:
                while (self._mesh_cache and sum(
                        len(v) for v in self._mesh_cache.values())
                        + len(data) > budget):
                    self._mesh_cache.pop(next(iter(self._mesh_cache)))
                self._mesh_cache[key] = data
        return data

    def _mesh(self, obj_id: int) -> bytes | None:
        """The .obj bytes of one object, meshed over every rank of a
        sharded server (the followers serialize nothing)."""
        from catnerf_torch.mesher.meshing import mesh_object

        mesh = mesh_object(self.session, obj_id,
                           device_mesh=self.device_mesh)
        if mesh is None:
            raise ValueError(f"object {obj_id} produced no surface")
        return mesh.obj_bytes() if pmesh.is_main() else None

    def render_scene_frame(self, frame: int, width: int, height: int,
                           n_bins: int) -> np.ndarray:
        if frame not in self.session.sample_dict:  # before any broadcast
            raise KeyError(f"unknown frame {frame}")
        T = np.asarray(self.session.sample_dict[frame]["T"], np.float32)
        return self._on_every_rank("_scene", T, width, height, n_bins)

    def render_scene_orbit(self, az_deg: float, el_deg: float, radius: float,
                           center, width: int, height: int,
                           n_bins: int) -> np.ndarray:
        T = look_at(orbit_eye(np.deg2rad(az_deg), np.deg2rad(el_deg),
                              radius, center), center)
        return self._on_every_rank("_scene", T, width, height, n_bins)

    def _scene(self, T, width: int, height: int, n_bins: int) -> np.ndarray:
        img, _, _ = render_scene_view(self.session, T,
                                      default_orbit_cam(width, height),
                                      near=0.05, far=scene_far(self.session),
                                      n_bins=n_bins,
                                      device_mesh=self.device_mesh)
        return img


_SIZES = ((160, 120), (320, 240), (640, 480), (1280, 960))
_BINS = (16, 32, 64, 96, 128, 192)

# Zero-dependency browser viewer served at "/": orbit sliders driving the
# /object, /edit and /scene endpoints (images re-requested on input).
# Plain inline HTML/JS — no external assets, works with zero egress.
_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>catnerf_torch viewer</title><style>
body{font-family:system-ui,sans-serif;margin:1.2rem;background:#16181d;
color:#dfe3ea}
fieldset{border:1px solid #394050;border-radius:6px;margin-bottom:.8rem}
label{margin-right:1rem;white-space:nowrap}
select,input{margin-left:.25rem}
#view{border:1px solid #394050;border-radius:4px;margin-top:.4rem;
image-rendering:auto;max-width:95vw}
#status{color:#8b93a7;font-size:.85rem;margin-left:.6rem}
a{color:#7aa2f7}
</style></head><body>
<h3 style="margin-top:0">catnerf_torch live viewer</h3>
<fieldset><legend>target</legend>
<label>mode <select id="mode">
  <option value="object">object orbit</option>
  <option value="scene">scene orbit</option>
  <option value="frame">scene from dataset pose</option>
</select></label>
<label id="l_obj">object <select id="obj"></select></label>
<label id="l_frame" hidden>frame <input id="frame" type="number" value="0"
 min="0" style="width:4rem"></label>
<label>size <select id="size">
  <option>160x120</option><option selected>320x240</option>
  <option>640x480</option><option>1280x960</option></select></label>
<label>bins <select id="bins"><option>16</option><option>32</option>
  <option selected>64</option><option>96</option><option>128</option>
  <option>192</option></select></label>
</fieldset>
<fieldset><legend>camera</legend>
<label>az <input id="az" type="range" min="0" max="360" value="30"></label>
<label>el <input id="el" type="range" min="-80" max="80" value="25"></label>
<label>radius <input id="radius" type="number" step="0.1" min="0"
 placeholder="auto" style="width:4.5rem"></label>
<span id="status"></span>
</fieldset>
<img id="view" alt="render">
<p>endpoints: <a href="/health">/health</a> /object /scene /edit /mesh
 (GET /mesh?id=N downloads the colored .obj) — POST /ingest adds a new
 instance from posed RGB-D observations.</p>
<script>
const $=id=>document.getElementById(id);
let inflight=false, dirty=false;
function url(){
  const [w,h]=$("size").value.split("x"), b=$("bins").value;
  const az=$("az").value, el=$("el").value, r=$("radius").value;
  const rq=r?`&radius=${r}`:"";
  if($("mode").value==="frame")
    return `/scene?frame=${$("frame").value}&w=${w}&h=${h}&bins=${b}`;
  if($("mode").value==="scene")
    return `/scene?az=${az}&el=${el}${r?`&radius=${r}`:"&radius=4"}`+
           `&w=${w}&h=${h}&bins=${b}`;
  return `/object?id=${$("obj").value}&az=${az}&el=${el}${rq}`+
         `&w=${w}&h=${h}&bins=${b}`;
}
function refresh(){
  if(inflight){dirty=true;return}
  inflight=true; $("status").textContent="rendering...";
  const t0=performance.now(), u=url();
  const img=new Image();
  img.onload=()=>{$("view").src=img.src;
    $("status").textContent=`${((performance.now()-t0)/1000).toFixed(2)} s`;
    inflight=false; if(dirty){dirty=false;refresh()}};
  img.onerror=()=>{$("status").textContent="error (see server log)";
    inflight=false};
  img.src=u+`&_=${Date.now()}`;
}
function modeChanged(){
  $("l_obj").hidden=$("mode").value!=="object";
  $("l_frame").hidden=$("mode").value!=="frame";
  refresh();
}
for(const id of ["obj","frame","size","bins","az","el","radius"])
  $(id).addEventListener("change",refresh);
$("mode").addEventListener("change",modeChanged);
fetch("/health").then(r=>r.json()).then(h=>{
  for(const o of h.objects){
    const e=document.createElement("option");e.textContent=o;
    $("obj").appendChild(e);}
  refresh();
});
</script></body></html>
"""


def _snap(value, allowed):
    """Nearest allowed value (tuples compare by their first element)."""
    key = (lambda a: abs(a[0] - value[0])) if isinstance(value, tuple) \
        else (lambda a: abs(a - value))
    return min(allowed, key=key)


def make_handler(server: SceneServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            with tracing.span("serve.write"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        @staticmethod
        @contextlib.contextmanager
        def _locked():
            """server.lock held over the block; the wait for it is the
            span serve.lock_wait."""
            with tracing.span("serve.lock_wait"):
                server.lock.acquire()
            try:
                yield
            finally:
                server.lock.release()

        def _json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        @staticmethod
        def _size(q):
            """Snap w/h/bins to the whitelist: free-form sizes would let a
            client grow the cached ray grids and a request's device memory
            without bound; the whitelist caps them at 4 cameras and the
            largest render at 1280 x 960 x 192 points. Called only by the
            branches that render — a junk ?w= on /health must not fail the
            liveness probe."""
            w, h = _snap((int(q.get("w", 320)), int(q.get("h", 240))),
                         _SIZES)
            return w, h, _snap(int(q.get("bins", 64)), _BINS)

        def do_GET(self):  # noqa: N802 (http.server API)
            u = urlparse(self.path)
            with tracing.span("serve.request", path=u.path):
                self._get(u)

        def _get(self, u):
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                if u.path in ("/", "/viewer"):
                    # lock-free static page; the images it requests go
                    # through the normal locked endpoints
                    self._reply(200, _VIEWER_HTML.encode(),
                                "text/html; charset=utf-8")
                elif u.path == "/health":
                    # lock-free: stays responsive during long device work
                    self._json(200, {"ok": True,
                                     "objects": server.object_ids()})
                elif u.path == "/object":
                    w, h, bins = self._size(q)
                    with self._locked():
                        img = server.render_object(
                            int(q["id"]), float(q.get("az", 0.0)),
                            float(q.get("el", 25.0)),
                            float(q["radius"]) if "radius" in q else None,
                            w, h, bins)
                    self._reply(200, _png(img), "image/png")
                elif u.path == "/edit":
                    w, h, bins = self._size(q)
                    with self._locked():
                        img = server.render_object_edit(
                            int(q["id"]), float(q.get("az", 0.0)),
                            float(q.get("el", 25.0)),
                            float(q["radius"]) if "radius" in q else None,
                            w, h, bins,
                            shape_from=(int(q["shape_from"])
                                        if "shape_from" in q else None),
                            texture_from=(int(q["texture_from"])
                                          if "texture_from" in q else None),
                            interp=(int(q["interp"])
                                    if "interp" in q else None),
                            t=float(q.get("t", 0.5)),
                            mean=q.get("mean", "0") not in ("0", "",
                                                            "false"))
                    self._reply(200, _png(img), "image/png")
                elif u.path == "/scene":
                    w, h, bins = self._size(q)
                    with self._locked():
                        if "frame" in q:
                            img = server.render_scene_frame(
                                int(q["frame"]), w, h, bins)
                        else:
                            center = (float(q.get("cx", 0.0)),
                                      float(q.get("cy", 0.0)),
                                      float(q.get("cz", 0.0)))
                            img = server.render_scene_orbit(
                                float(q.get("az", 0.0)),
                                float(q.get("el", 25.0)),
                                float(q.get("radius", 4.0)), center,
                                w, h, bins)
                    self._reply(200, _png(img), "image/png")
                elif u.path == "/mesh":
                    with self._locked():
                        data = server.mesh_obj(int(q["id"]))
                    self._reply(200, data, "model/obj")
                else:
                    self._json(404, {"error": f"unknown path {u.path}"})
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-reply (canceled image load, curl
                # timeout): nothing to send, and writing a 500 onto the
                # dead socket would raise again and dump a traceback per
                # dropped connection
                return
            except (KeyError, ValueError) as e:
                self._json(400, {"error": repr(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._json(500, {"error": repr(e)})

        _MAX_INGEST_BYTES = 1 << 30  # bound host memory per request
        _MAX_DRAIN_BYTES = 64 << 20  # error-path body drain cap

        def _drain(self, n: int) -> None:
            """Read and discard up to _MAX_DRAIN_BYTES of a request body
            before an error reply: closing the socket while the client is
            still streaming resets the connection and the client never
            sees the diagnostic JSON written for exactly that case."""
            try:
                left = min(n, self._MAX_DRAIN_BYTES)
                while left > 0:
                    chunk = self.rfile.read(min(1 << 16, left))
                    if not chunk:
                        break
                    left -= len(chunk)
            except OSError:
                pass

        def do_POST(self):  # noqa: N802 (http.server API)
            u = urlparse(self.path)
            with tracing.span("serve.request", path=u.path):
                self._post(u)

        def _post(self, u):
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                n = max(0, int(self.headers.get("Content-Length", 0) or 0))
            except ValueError:
                n = 0
            body_read = False
            try:
                if u.path != "/ingest":
                    self._drain(n)
                    self._json(404, {"error": f"unknown path {u.path}"})
                    return
                if n <= 0:
                    raise ValueError("POST /ingest needs an .npz body "
                                     "(Content-Length missing or 0)")
                if n > self._MAX_INGEST_BYTES:
                    raise ValueError(f"body too large ({n} bytes; cap "
                                     f"{self._MAX_INGEST_BYTES})")
                body = self.rfile.read(n)
                body_read = True
                with self._locked():  # ingest mutates the session
                    out = server.ingest(body, q)
                self._json(200, out)
            except (BrokenPipeError, ConnectionResetError):
                return  # client went away; see do_GET
            except (KeyError, ValueError) as e:
                if not body_read:
                    self._drain(n)
                self._json(400, {"error": repr(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._json(500, {"error": repr(e)})

    return Handler


def warmup(server: SceneServer, width: int = 320, height: int = 240,
           n_bins: int = 64) -> None:
    """Render the default-size object and scene views once before the
    first request: the device's first-use costs (the allocator's first
    blocks, the matmul handles) and the cached ray grid are paid there, so
    a warmed server answers its first real request at steady-state
    latency."""
    objs = server.object_ids()
    if objs:
        server.render_object(objs[0], 0.0, 25.0, None, width, height, n_bins)
    server.render_scene_orbit(0.0, 25.0, 4.0, (0.0, 0.0, 0.0),
                              width, height, n_bins)


def serve(session, port: int = 8765, host: str = "127.0.0.1",
          scene_server: SceneServer | None = None) -> HTTPServer:
    """Build the (not-yet-running) HTTP server; port 0 takes a free port
    (`httpd.server_address[1]`). Threaded: device work serializes on the
    SceneServer lock, but /health (and reading request bodies) proceed
    concurrently, so liveness probes are never starved by a long render or
    ingest."""
    scene_server = scene_server or SceneServer(session)
    httpd = ThreadingHTTPServer((host, port), make_handler(scene_server))
    httpd.daemon_threads = True
    return httpd


def follow(scene_server: SceneServer) -> int:
    """Every rank but 0 of a sharded server: make each call rank 0
    broadcasts (`SceneServer._on_every_rank`) until its stop, then return
    0. A call that raises here raised on rank 0 too, which answers the
    request with it; the loop goes on."""
    while True:
        op, args = pmesh.broadcast_object(None, group=scene_server._group)
        if op == _STOP:
            return 0
        if op not in _FOLLOWED:
            raise RuntimeError(f"follow: unknown call {op!r}")
        try:
            getattr(scene_server, op)(*args)
        except Exception as e:  # noqa: BLE001 (rank 0 reports it)
            print(f"follow: {op} raised {e!r}", file=sys.stderr, flush=True)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def serve_sharded(scene_server: SceneServer, httpd: HTTPServer) -> int:
    """Rank 0 of a sharded server: serve until `httpd.shutdown()` (from
    another thread), a KeyboardInterrupt or SIGTERM, then, hazard
    shutdown, broadcast the stop so that every follower returns, and
    close the socket. Returns 0."""
    import signal

    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:
        previous = signal.signal(signal.SIGTERM, _interrupt)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
        scene_server.stop()
        httpd.server_close()
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m catnerf_torch.serve",
                                     description=__doc__.splitlines()[0])
    add_scene_args(parser)
    parser.add_argument("--port", type=int, default=8765,
                        help="0 takes a free port")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--warmup", action="store_true",
                        help="render the default-size views once before "
                             "accepting requests")
    parser.add_argument("--sharded", action="store_true",
                        help="shard /scene composites and /mesh over every "
                             "process (torchrun --nproc-per-node N; "
                             "identical pixels and bytes)")
    args = parser.parse_args(argv)

    device_mesh = (pmesh.cli_mesh(args.device, "--sharded")
                   if args.sharded else None)
    try:
        session = restore_session(args)
        scene_server = SceneServer(session,
                                   ckpt_dir=os.path.join(args.logdir, "ckpt"),
                                   device_mesh=device_mesh)
        if device_mesh is not None and not pmesh.is_main():
            return follow(scene_server)
        if args.warmup:
            import time

            t0 = time.time()
            warmup(scene_server)
            print(f"warmup done in {time.time() - t0:.1f}s", flush=True)
        httpd = serve(session, port=args.port, host=args.host,
                      scene_server=scene_server)
        if device_mesh is not None:
            print(f"scene renders sharded over {device_mesh.size()} "
                  f"processes", flush=True)
        print(f"serving {len(session.cls_ids)} categories on "
              f"{session.device} at "
              f"http://{args.host}:{httpd.server_address[1]} (endpoints: "
              f"/health /object /scene /edit /mesh /ingest)", flush=True)
        if device_mesh is not None:
            return serve_sharded(scene_server, httpd)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return 0
    finally:
        if device_mesh is not None:
            pmesh.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
