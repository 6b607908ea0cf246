"""Kernels 3 and 4 (the background forward and backward of
`csrc/occupancy.cu`) at a background width (the shipped 128 unless
--width says another) of this checkout and of another, on the card, in
one call: their outputs bitwise and their device times in turns.

    python catnerf_torch/experimental/occupancy_compare.py --other DIR \
        [--width H]

DIR holds another checkout's `catnerf_torch` (unpack it with `git archive`
under the ignored `build/`). Each side runs in a subprocess of its own
(the two packages share a name), in the order other, this, this, other:
from the same seeded inputs at 16,800 rows (the bench step's background),
16,801 and 77, the forward's output and the backward's three outputs,
compared bitwise between the two checkouts; at 16,800 rows, the device
time of one call of each with 50 calls queued back to back behind a
device-side sleep (CUDA events), and the device time of each kernel of
the backward (torch.profiler). Prints the card's name and power limit, a
line a run, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROWS = (16800, 16801, 77)
N_QUEUED = 50


def _device_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * N_QUEUED * host_s) * 2e9))
    a.record()
    for _ in range(N_QUEUED):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / N_QUEUED


def _pieces(fn, n: int = 20) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name)
            name = re.sub(r"\(.*\)$", "", name)
            out[name] = (out.get(name, 0.0)
                         + e.time_range.elapsed_us() / 1e3 / n)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run_side(root: str, out_path: str, width: int) -> None:
    """One checkout's outputs and times at background width `width`,
    saved to out_path."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from catnerf_torch.kernels import fused_field as ff
    from catnerf_torch.models.embedding import UniDirsEmbed
    from catnerf_torch.models.occupancy import OccupancyMap

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    flat = ff.pack(ff._oc_modules(OccupancyMap.init(
        gen, hidden_size=width))).detach().cuda()
    B = (UniDirsEmbed.init().B.detach()
         + 0.05 * torch.randn(21, 3, generator=gen)).cuda()
    outputs, times = {}, {}
    for n in ROWS:
        pts = (torch.randn(n, 3, generator=gen) * 2.0).cuda()
        dout = torch.randn(n, 4, generator=gen).cuda()

        def fwd():
            return ff.occupancy_fwd_cuda(flat, B, pts, 0.2, width)

        def bwd():
            return ff.occupancy_bwd_cuda(flat, B, pts, dout, 0.2, width)

        outputs[n] = [fwd().cpu()] + [x.cpu() for x in bwd()]
        if n == ROWS[0]:
            times = {"fwd_ms": _device_ms(fwd), "bwd_ms": _device_ms(bwd),
                     "bwd_pieces_ms": _pieces(bwd)}
    torch.save({"outputs": outputs, "times": times}, out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root")
    ap.add_argument("--width", type=int, default=128,
                    help="the background's hidden width")
    ap.add_argument("--side", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side is not None:
        run_side(args.side, args.out, args.width)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("occupancy_compare: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0],
          flush=True)
    this = str(Path(__file__).resolve().parents[2])
    sides = {"other": str(Path(args.other).resolve()), "this": this}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, label in enumerate(("other", "this", "this", "other")):
            path = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--other", args.other,
                            "--width", str(args.width), "--side",
                            sides[label], "--out", path], check=True)
            res = torch.load(path)
            runs.append((label, res))
            t = res["times"]
            print(f"{label}: queued ms forward {t['fwd_ms']:.4f}, backward "
                  f"{t['bwd_ms']:.4f}; the backward's kernels (ms a call) "
                  + json.dumps({k[:40]: round(v, 4) for k, v in
                                t["bwd_pieces_ms"].items()}), flush=True)
    first = {label: res["outputs"] for label, res in reversed(runs)}
    bitwise = {str(n): [bool(torch.equal(a, b)) for a, b in
                        zip(first["this"][n], first["other"][n])]
               for n in ROWS}
    print(json.dumps({
        "width": args.width,
        "bitwise": bitwise,
        "fwd_ms": {k: [r["times"]["fwd_ms"] for lb, r in runs if lb == k]
                   for k in sides},
        "bwd_ms": {k: [r["times"]["bwd_ms"] for lb, r in runs if lb == k]
                   for k in sides}}), flush=True)
    return 0 if all(all(v) for v in bitwise.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
