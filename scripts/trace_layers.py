"""Device time per kernel of the flagship VGA serving step, from a trace.

    python scripts/trace_layers.py [--batch 32] [--steps 5] [--out traces]

Builds ``make_batched_detector_boxes(flagship, (480, 640), nms_iou=0.5)``,
warms it up, then traces ``--steps`` steps on scene frames and on
uniform-noise frames with ``jax.profiler``.  For each frame kind it prints
the card's name and power limit, the summed device time of every kernel
name per step, the total device kernel time per step and the traced
window (first kernel start to last kernel end) per step; their difference
is the device's idle time inside the window.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_events(xplane_path):
    """(name -> summed ns, name -> count, window ns) over the GPU stream
    lines of one xplane file."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    tot, cnt = collections.Counter(), collections.Counter()
    lo = hi = None
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
                cnt[ev.name] += 1
                end = ev.start_ns + ev.duration_ns
                lo = ev.start_ns if lo is None else min(lo, ev.start_ns)
                hi = end if hi is None else max(hi, end)
    return tot, cnt, (hi - lo) if lo is not None else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=os.path.join(ROOT, "traces"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import waldboost_tpu as wb
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes
    from waldboost_tpu.utils import scene_generator

    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    model = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    B, S = args.batch, args.steps
    gen = scene_generator(seed=100, hw=(480, 640))
    scene = np.stack([next(gen)["image"] for _ in range(B)]).astype(np.uint8)
    noise = np.random.RandomState(0).randint(0, 256, (B, 480, 640)) \
        .astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, (480, 640), nms_iou=0.5,
                                        with_n_weak=False)
    for tag, x in (("scene", scene), ("noise", noise)):
        xd = jnp.asarray(x)
        jax.block_until_ready(fn(xd))
        jax.block_until_ready(fn(xd))
        d = os.path.join(args.out, tag)
        jax.profiler.start_trace(d)
        for _ in range(S):
            r = fn(xd)
        jax.block_until_ready(r)
        jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(
            d, "plugins", "profile", "*", "*.xplane.pb")))[-1]
        tot, cnt, window = device_events(path)
        busy = sum(tot.values())
        print(f"== {tag}: {S} steps of batch {B}; device kernel time "
              f"{busy / S / 1e6:.3f} ms/step; window {window / S / 1e6:.3f}"
              f" ms/step", flush=True)
        for name, ns in tot.most_common(args.top):
            print(f"   {ns / S / 1e6:8.4f} ms/step  x{cnt[name] // S:3d}  "
                  f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
