"""The cascade kernel alone vs the XLA lockstep evaluator, and a tile sweep.

    python scripts/kernel_timing.py [--batch 32] [--reps 20] [--frames noise|scene]

On one batch of flagship VGA canvases (models/flagship_synth_64.pb, full
pyramid), checks that the kernel equals the lockstep evaluator, then
prints the median and minimum wall time (each call ends in
``block_until_ready``) of: the channel canvas, the masked kernel with and
without its n_weak counter, the XLA lockstep scan, and the masked kernel
at each tile shape of ``--tiles``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timeit(fn, *args, reps=20):
    """(median, min) ms over ``reps`` calls after two warm-up calls."""
    import jax
    for _ in range(2):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3, float(np.min(ts)) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", choices=("noise", "scene"), default="noise")
    ap.add_argument("--tiles", default="16x64,16x128,32x32,32x64,32x128,"
                    "64x64")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import waldboost_tpu as wb
    from waldboost_tpu.ops.cascade import cascade_response_grid
    from waldboost_tpu.ops.cascade_kernel import cascade_dense, cascade_masked
    from waldboost_tpu.parallel.detect import make_batched_detector
    from waldboost_tpu.utils import scene_generator

    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    model = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    m, n, _ = model.shape
    casc, meta = model._get_cascade()
    canvas_b, _, _, packed = make_batched_detector(model, (480, 640),
                                                   _raw=True)
    valid = jnp.asarray(packed.valid_mask((m, n)))
    B = args.batch
    if args.frames == "scene":
        gen = scene_generator(seed=100, hw=(480, 640))
        imgs = np.stack([next(gen)["image"] for _ in range(B)])
    else:
        imgs = np.random.RandomState(0).randint(0, 256, (B, 480, 640))
    imgs = jnp.asarray(imgs.astype(np.uint8))
    canvas_j = jax.jit(canvas_b)
    cvs = jax.block_until_ready(canvas_j(imgs))
    ref_j = jax.jit(jax.vmap(lambda cv: cascade_response_grid(
        cv, casc, (m, n), meta, init_alive=valid)))

    hs0, al0, nw0 = (np.asarray(x) for x in ref_j(cvs))
    hs1, al1, nw1 = (np.asarray(x) for x in cascade_dense(
        cvs, casc, meta, valid, (m, n)))
    same = (np.array_equal(al0, al1)
            and np.array_equal(hs0.view(np.int32), hs1.view(np.int32))
            and np.array_equal(nw0, nw1))
    print(f"{args.frames} canvases {tuple(cvs.shape)}: kernel equals the "
          f"lockstep evaluator {same}; survivors/frame "
          f"{float(al0.sum()) / B:.1f}", flush=True)
    if not same:
        return 1

    def masked(c, **kw):
        return cascade_masked(c, casc, meta, valid, (m, n), **kw)

    rows = [("channel canvas", canvas_j, imgs),
            ("kernel masked", masked, cvs),
            ("kernel masked, no n_weak",
             lambda c: masked(c, with_n_weak=False), cvs),
            ("xla lockstep", ref_j, cvs)]
    for spec in args.tiles.split(","):
        tile = tuple(int(v) for v in spec.split("x"))
        rows.append((f"kernel tile {spec}, no n_weak",
                     lambda c, t=tile: masked(c, with_n_weak=False, tile=t),
                     cvs))
    for label, fn, x in rows:
        med, best = timeit(fn, x, reps=args.reps)
        print(f"  {label}: median {med:.3f} ms, min {best:.3f} ms "
              f"(batch {B})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
