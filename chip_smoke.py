"""Smoke test: the serving and training paths, compiled on one NVIDIA GPU.

    python chip_smoke.py          # one card: kernel, serving, training
    python chip_smoke.py --four   # four cards: sharded serving and training

Runs the flagship detector (models/flagship_synth_64.pb: 64 depth-2 trees,
12x12x4 grad_hist window, shrink=2, n_per_oct=8, smooth=1) over full
640x480 pyramids through the user entry points, and checks every output
against the repo's own references:

  (a) device   JAX's default device must be a GPU;
  (b) kernel   the cascade kernel vs the XLA lockstep evaluator on a batch
               of 8 VGA canvases (f32 at two tile shapes, and the bf16
               canvas of fast mode): identical survivors, bitwise scores,
               equal counts and n_weak;
  (c) serve    make_batched_detector_boxes(nms_iou=0.5) on uint8 frames
               equals the committed CPU golden bitwise; float frames stay
               within 512 ULP / 2e-4 of the CPU channels; fast mode stays
               within its box-difference bound; BucketedDetector
               on a mixed 640x480 / 1242x375 queue equals the per-size path;
  (d) train    wb.train with the host pool and with the device pool (4
               stages each), then the tree fit at the device pool's
               capacity: histograms vs float64 NumPy, splits vs the CPU.

Any failed check exits nonzero.  The last line of standard output is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def timed(label, fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    log(f"  {label}: {time.perf_counter() - t0:.2f} s (compile + run)")
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def serving_mode(mode):
    """Build serving programs under ``WB_SERVING_MODE=mode`` (read at build
    time), restoring the caller's setting afterwards."""
    prev = os.environ.get("WB_SERVING_MODE")
    os.environ["WB_SERVING_MODE"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("WB_SERVING_MODE", None)
        else:
            os.environ["WB_SERVING_MODE"] = prev


def kernel_matches_lockstep(label, cvs, casc, meta, valid, window, **kw):
    """The cascade kernel, dense and masked forms, vs the XLA lockstep
    evaluator on one canvas batch: identical survivors, bitwise scores,
    equal counts and n_weak.  Returns the lockstep survivor map."""
    import jax

    from waldboost_tpu.ops.cascade import cascade_response_grid
    from waldboost_tpu.ops.cascade_kernel import cascade_dense, cascade_masked

    ref = jax.jit(jax.vmap(lambda cv: cascade_response_grid(
        cv, casc, window, meta, init_alive=valid)))
    hs0, al0, nw0 = (np.asarray(x) for x in timed(
        f"{label}: xla lockstep", ref, cvs))
    hs1, al1, nw1 = (np.asarray(x) for x in timed(
        f"{label}: kernel dense",
        lambda c: cascade_dense(c, casc, meta, valid, window, **kw), cvs))
    mk, nw2, cnt = (np.asarray(x) for x in timed(
        f"{label}: kernel masked",
        lambda c: cascade_masked(c, casc, meta, valid, window, **kw), cvs))
    gu, gv = al0.shape[1:]
    same_alive = np.array_equal(al0, al1)
    same_scores = np.array_equal(hs0.view(np.int32), hs1.view(np.int32))
    masked_ok = (np.array_equal(np.isfinite(mk[:, :gu, :gv]), al0)
                 and int(np.isfinite(mk).sum()) == int(al0.sum())
                 and np.array_equal(mk[:, :gu, :gv][al0].view(np.int32),
                                    hs0[al0].view(np.int32)))
    counts_ok = np.array_equal(cnt, al0.sum(axis=(1, 2)))
    nweak_ok = np.array_equal(nw0, nw1) and np.array_equal(nw0, nw2)
    log(f"  {label}: identical survivors {same_alive}, bitwise scores "
        f"{same_scores}, masked map {masked_ok}, counts {counts_ok}, "
        f"n_weak {nweak_ok}")
    check(same_alive and same_scores and masked_ok and counts_ok
          and nweak_ok, f"{label}: kernel differs from the XLA lockstep "
          "evaluator")
    return al0, nw0


def phase_kernel(model, u8):
    import jax
    import jax.numpy as jnp

    from waldboost_tpu.ops.cascade_kernel import TILE
    from waldboost_tpu.parallel.detect import make_batched_detector

    m, n, _ = model.shape
    casc, meta = model._get_cascade()
    rng = np.random.RandomState(7)
    frames = jnp.asarray(np.concatenate(
        [u8, rng.randint(0, 256, (2, 480, 640)).astype(np.uint8)]))
    canvas_b, _, _, packed = make_batched_detector(model, (480, 640),
                                                   _raw=True)
    valid = jnp.asarray(packed.valid_mask((m, n)))
    cvs = timed(f"canvas {tuple(frames.shape)}", jax.jit(canvas_b), frames)
    gu, gv = valid.shape
    log(f"  canvas batch {tuple(cvs.shape)} {cvs.dtype}; window grid "
        f"{gu} x {gv} (tile {TILE[0]} x {TILE[1]} does not divide it)")
    al, nw = kernel_matches_lockstep("f32 canvas", cvs, casc, meta, valid,
                                     (m, n))
    log(f"  survivors/frame {al.sum(axis=(1, 2)).tolist()}  "
        f"eval_cost/frame {np.round(nw / int(valid.sum()), 3).tolist()}")
    kernel_matches_lockstep("f32 canvas, tile 32 x 128", cvs, casc, meta,
                            valid, (m, n), tile=(32, 128))
    # fast serving mode: the bf16 canvas of the fast channel chain
    with serving_mode("fast"):
        fast_b, _, _, _ = make_batched_detector(model, (480, 640), _raw=True)
    cvf = timed("fast canvas", jax.jit(fast_b), frames)
    check(cvf.dtype == jnp.bfloat16, f"fast canvas is {cvf.dtype}, not bf16")
    kernel_matches_lockstep("bf16 fast canvas", cvf, casc, meta, valid,
                            (m, n))


def phase_serve(model, u8, flt):
    import jax
    import jax.numpy as jnp

    from waldboost_tpu.channels import _normalize_opts
    from waldboost_tpu.golden import (box_rows_equal, load_golden,
                                      serving_boxes)
    from waldboost_tpu.model import _packed_plan_cached
    from waldboost_tpu.parallel.bucket import BucketedDetector
    from waldboost_tpu.polyphase import _channel_canvas_batch
    from waldboost_tpu.testing import ulp_distance
    from waldboost_tpu.utils import scene_generator

    gold_u8, gcount_u8 = load_golden("u8")
    t0 = time.perf_counter()
    got, count = serving_boxes(model, u8)
    log(f"  uint8 serving: {time.perf_counter() - t0:.2f} s (compile + run)")
    same = [box_rows_equal(a, b) for a, b in zip(got, gold_u8)]
    log(f"  uint8 boxes/frame {[len(g) for g in got]}  equal to golden "
        f"{same}  counts {count.tolist()} vs {gcount_u8.tolist()}")
    check(all(same) and np.array_equal(count, gcount_u8),
          "uint8 serving differs from the CPU golden")
    # a few more batches through the same program: well-formed outputs
    # (count -1 flags a survivor set beyond the extraction capacity)
    gen = scene_generator(seed=99, hw=(480, 640))
    for i in range(2):
        more = np.stack([next(gen)["image"] for _ in range(6)])
        rows, cnt = serving_boxes(model, more.astype(np.uint8))
        check(all(np.isfinite(r).all() for r in rows),
              f"extra serving batch {i} malformed")
        log(f"  extra batch {i}: boxes/frame {[len(r) for r in rows]}, "
            f"survivors {cnt.tolist()}")

    # fast serving mode (bf16 canvas, no exactness contract): box sets stay
    # within the bound tests/test_fast_mode.py holds on the CPU
    with serving_mode("fast"):
        got_fast, _ = serving_boxes(model, u8)

    def rects(rows):
        return {tuple(np.round(r[:4], 2)) for r in rows}

    flips = sum(len(rects(a) ^ rects(b)) for a, b in zip(got_fast, gold_u8))
    total = sum(max(len(g), 1) for g in gold_u8)
    log(f"  fast mode: boxes/frame {[len(g) for g in got_fast]}, box-set "
        f"differences from the exact golden {flips} of {total}")
    check(all(np.isfinite(r).all() for r in got_fast)
          and flips <= 0.25 * total, "fast-mode serving beyond its bound")

    # float frames: the double-float channel chain on the GPU vs the CPU
    m, n, _ = model.shape
    shrink, npo, smooth, cf = _normalize_opts(model.channel_opts)
    packed = _packed_plan_cached(480, 640, shrink, npo, (m, n), halo=cf.halo)
    canvas = jax.jit(lambda ims: _channel_canvas_batch(ims, shrink, npo,
                                                       smooth, cf, packed))
    cv_gpu = np.asarray(canvas(jnp.asarray(flt)))
    cpu = jax.devices("cpu")[0]
    cv_cpu = np.asarray(canvas(jax.device_put(flt, cpu)))
    ulp = ulp_distance(cv_gpu, cv_cpu)
    dif = np.abs(cv_gpu.astype(np.float64) - cv_cpu)
    bad = int(((ulp > 512) & (dif > 2e-4)).sum())
    log(f"  float channels GPU vs CPU: {cv_gpu.size} values, "
        f"{float((ulp == 0).mean()) * 100:.4f}% bitwise, max {int(ulp.max())}"
        f" ULP, max abs {float(dif.max()):.3e}, beyond 512 ULP and 2e-4: "
        f"{bad}")
    gold_f, gcount_f = load_golden("float")
    got_f, count_f = serving_boxes(model, flt)
    flips = [len({tuple(r) for r in a} ^ {tuple(r) for r in b})
             for a, b in zip(got_f, gold_f)]
    log(f"  float boxes/frame {[len(g) for g in got_f]}  vs golden "
        f"{[len(g) for g in gold_f]}  box-set differences {flips}")
    check(bad == 0, "float channels beyond 512 ULP / 2e-4 of the CPU path")

    # mixed-resolution queue: BucketedDetector vs golden / per-size path
    kitti_gen = scene_generator(seed=5, hw=(375, 1242))
    kitti = np.stack([next(kitti_gen)["image"] for _ in range(2)]) \
        .astype(np.uint8)
    queue = [u8[0], kitti[0], u8[1], u8[2], kitti[1], u8[3], u8[4], u8[5]]
    det = BucketedDetector(model, nms_iou=0.5, k=1024)
    t0 = time.perf_counter()
    out = det.detect_many(queue)
    log(f"  bucketed queue of {len(queue)}: "
        f"{time.perf_counter() - t0:.2f} s, {det.compiles} bucket programs")

    def rows(bx):
        r = np.concatenate([bx.get(), bx.get_field("scores")[:, None]],
                           axis=1).astype(np.float32)
        return r[np.lexsort(r.T[::-1])]

    kitti_ref, _ = serving_boxes(model, kitti)
    want = [gold_u8[0], kitti_ref[0], gold_u8[1], gold_u8[2], kitti_ref[1],
            gold_u8[3], gold_u8[4], gold_u8[5]]
    same = [box_rows_equal(rows(b), w) for b, w in zip(out, want)]
    log(f"  bucketed boxes equal to golden / per-size path: {same}")
    check(all(same), "bucketed serving differs from the per-size path")


def phase_train():
    import waldboost_tpu as wb
    from waldboost_tpu.parallel.mesh import make_mesh
    from waldboost_tpu.utils import fake_data_generator

    opts = dict(shrink=2, n_per_oct=4, smooth=1, channels="grad_hist")
    pools = {}
    for name, mesh in (("host pool", None), ("device pool", make_mesh(1))):
        gen = fake_data_generator(seed=11)
        model = wb.Model((12, 12, 4), opts)
        pool = wb.SamplePool(min_tp=1000, min_fp=1000, seed=0)
        t0 = time.perf_counter()
        learner = wb.train(model, gen, pool=pool, length=4, mesh=mesh,
                           learner=wb.Learner(alpha=0.2, max_depth=2))
        dt = time.perf_counter() - t0
        fpr = learner.get_stats()["false_positive_rate"]
        losses = learner.get_stats()["loss"]
        log(f"  {name}: {len(model)} stages in {dt:.1f} s, loss "
            f"{np.round(losses, 4).tolist()}, fpr {np.round(fpr, 4).tolist()}"
            f", eval_cost {model.eval_cost:.3f}")
        check(len(model) >= 4 and np.isfinite(losses).all(),
              f"{name} training: too few stages or non-finite loss")
        check(fpr[-1] < fpr[0] and np.all(np.diff(fpr) <= 0),
              f"{name} training: false-positive rate does not fall")
        check(0 < model.eval_cost < len(model),
              f"{name} training: eval_cost not below the stage count")
        pools[name] = pool

    fit_check(pools["host pool"])


def fit_check(pool):
    """The tree fit at the device pool's capacity (2 x 2048 rows of 576
    features): its class-mass histograms vs float64 NumPy, and the whole
    fit vs the same program on the CPU."""
    import jax
    import jax.numpy as jnp

    from waldboost_tpu.ops.fit import fit_tree_complete, indicator_histogram
    from waldboost_tpu.parallel.trainer import DevicePool

    X0, _ = pool.get_false_positives()
    X1, _ = pool.get_true_positives()
    F = int(np.prod(X0.shape[1:]))
    cap = DevicePool(2 * max(1000, 1000), F).capacity

    def lay(X):  # one class laid out as the device pool holds it
        X = X.reshape(len(X), F)[:cap].astype(np.float32)
        v = np.arange(cap) < len(X)
        return np.pad(X, ((0, cap - len(X)), (0, 0))), v

    (x0, v0), (x1, v1) = lay(X0), lay(X1)
    xf = np.concatenate([x0, x1])
    valid = np.concatenate([v0, v1])
    y = np.repeat(np.arange(2, dtype=np.int32), cap)
    rng = np.random.RandomState(1)
    w = np.where(valid, rng.rand(2 * cap), 0.0).astype(np.float32)
    ws = np.where(y == 0, w / w[y == 0].sum(), w / w[y == 1].sum()) / 2
    ws = ws.astype(np.float32)

    # the root level's histograms, as fit_tree_complete computes them
    wc = np.stack([np.where(y == c, ws, 0) for c in (0, 1)])
    B = 256
    edges = np.quantile(xf[valid], np.arange(1, B) / B, axis=0) \
        .astype(np.float32)
    got = np.asarray(jax.jit(indicator_histogram)(
        jnp.asarray(wc), jnp.asarray(xf), jnp.asarray(edges)))
    ref = np.zeros(got.shape, np.float64)
    for f in range(F):
        order = np.argsort(xf[:, f], kind="stable")
        xs = xf[order, f]
        cum = np.cumsum(wc[:, order].astype(np.float64), axis=1)
        k = np.searchsorted(xs, edges[:, f], side="right")
        ref[:, f, :] = np.where(k > 0, cum[:, np.maximum(k - 1, 0)], 0.0)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    rel = np.where(ref > 0, rel, np.abs(got))
    # f32 sums of <= cap positive addends per class in another order than
    # NumPy's: worst case n * 2^-24 relative
    tol = cap * 2.0 ** -24
    log(f"  histograms {got.shape} over {int(valid.sum())} samples in "
        f"{xf.shape[0]} rows: max rel error {float(rel.max()):.3e} at "
        f"HIGHEST (bound {tol:.2e})")
    check(float(rel.max()) <= tol, "histogram beyond the f32 reorder bound")

    args = (xf, y, ws, w, valid)
    gpu = timed(f"fit_tree_complete {xf.shape}", fit_tree_complete,
                *(jnp.asarray(a) for a in args))
    cpu_dev = jax.devices("cpu")[0]
    cpu = fit_tree_complete(*(jax.device_put(a, cpu_dev) for a in args))
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(gpu[:4], cpu[:4]))
    pred_dev = float(np.max(np.abs(np.asarray(gpu.pred)
                                   - np.asarray(cpu.pred))))
    log(f"  tree fit on the card vs the CPU: same splits {same}, features "
        f"{np.asarray(gpu.feature).tolist()}, max leaf difference "
        f"{pred_dev:.3e}")
    check(same and pred_dev <= 1e-5, "tree fit differs from the CPU's")


def phase_four():
    import jax

    check(len(jax.devices()) >= 4, "--four needs four devices")
    four_serving()
    four_training()


def peaks():
    import jax
    return np.array([(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                     for d in jax.devices()[:4]], np.int64)


def four_serving():
    import jax.numpy as jnp

    import waldboost_tpu as wb
    from waldboost_tpu.golden import box_rows_equal, golden_frames
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes
    from waldboost_tpu.parallel.mesh import make_mesh, shard_array

    t0 = time.perf_counter()
    model = wb.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"))
    u8, _ = golden_frames()
    rng = np.random.RandomState(3)
    frames = np.concatenate([u8, rng.randint(0, 256, (2, 480, 640))
                             .astype(np.uint8)])

    def boxes(mesh):
        fn, _ = make_batched_detector_boxes(model, (480, 640), nms_iou=0.5,
                                            k=1024, mesh=mesh)
        x = shard_array(frames, mesh) if mesh is not None \
            else jnp.asarray(frames)
        res = fn(x)
        rects, scores, valid, count, _ = (np.asarray(a) for a in res)
        out = []
        for b in range(len(frames)):
            r = np.concatenate([rects[b][valid[b]],
                                scores[b][valid[b]][:, None]], axis=1)
            out.append(r[np.lexsort(r.T[::-1])].astype(np.float32))
        return out, count, res[0]

    # the sharded run first, so each card's peak memory shows its own share
    p0 = peaks()
    four, c4, rects4 = boxes(make_mesh(4))
    grew = peaks() - p0
    one, c1, _ = boxes(None)
    same = [box_rows_equal(a, b) for a, b in zip(one, four)]
    shards = sorted((s.device.id, s.data.shape[0])
                    for s in rects4.addressable_shards)
    log(f"  sharded serving on 4 cards equals one card: {same}, counts "
        f"{c4.tolist()} ({time.perf_counter() - t0:.1f} s)")
    log(f"  placement: box rows per card (device, frames) {shards}; peak "
        f"bytes each card gained during the sharded run {grew.tolist()}")
    check(all(same) and np.array_equal(c1, c4),
          "sharded serving differs from one card")
    check(len({d for d, _ in shards}) == 4
          and all(k == len(frames) // 4 for _, k in shards)
          and grew.min() > 0.25 * grew.max(),
          "sharded serving did not spread its work over the 4 cards")


def four_training():
    import jax

    import waldboost_tpu as wb
    from waldboost_tpu.parallel.mesh import make_mesh
    from waldboost_tpu.parallel.trainer import DevicePool
    from waldboost_tpu.proto import codec
    from waldboost_tpu.utils import fake_data_generator

    t0 = time.perf_counter()
    F = 12 * 12 * 4
    cap = DevicePool(2 * max(1000, 1000), F).capacity
    layouts = set()

    def pool_layout(model, learner, stage):
        # the sample pools at rest: (capacity, F) arrays on the mesh
        for a in jax.live_arrays():
            if a.shape == (cap, F) and len(a.sharding.device_set) == 4:
                layouts.add(tuple(sorted((s.device.id, s.data.shape[0])
                                         for s in a.addressable_shards)))

    def train(mesh, callbacks=()):
        gen = fake_data_generator(seed=13)
        model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                           channels="grad_hist"))
        pool = wb.SamplePool(min_tp=1000, min_fp=1000, seed=3)
        learner = wb.train(model, gen, pool=pool, length=4, mesh=mesh,
                           learner=wb.Learner(alpha=0.2, max_depth=2),
                           callbacks=callbacks)
        return model, learner

    p0 = peaks()
    m4, l4 = train(make_mesh(4), callbacks=(pool_layout,))
    grew = peaks() - p0
    m1, l1 = train(make_mesh(1))
    p1, p4 = codec.Model(), codec.Model()
    m1.as_proto(p1)
    m4.as_proto(p4)
    bitwise = p1.SerializeToString() == p4.SerializeToString()
    log(f"  sharded training on 4 cards: {len(m4)} stages, model bitwise "
        f"equal to a 1-device mesh: {bitwise}; losses "
        f"{np.round(l1.losses, 6).tolist()} vs "
        f"{np.round(l4.losses, 6).tolist()} ({time.perf_counter() - t0:.1f}"
        " s)")
    log(f"  placement: sample-pool layouts (device, rows) {sorted(layouts)}"
        f"; peak bytes each card gained during 4-card training "
        f"{grew.tolist()}")
    check(bitwise, "4-card trained model differs from the 1-device model")
    check(len(layouts) > 0 and all(
        len({d for d, _ in lay}) == 4 and all(k == cap // 4 for _, k in lay)
        for lay in layouts), "the sample pools are not sharded over 4 cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"FAIL: no GPU: JAX's default device is {devs[0]}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import waldboost_tpu as wb
    except ImportError as e:
        print(f"FAIL: cannot import the program: {e}", file=sys.stderr)
        return 2

    log(card_line())
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    t_start = time.perf_counter()
    try:
        if args.four:
            log("[four] sharded serving and training")
            phase_four()
        else:
            from waldboost_tpu.golden import golden_frames
            model = wb.load(os.path.join(ROOT, "models",
                                         "flagship_synth_64.pb"))
            u8, flt = golden_frames()
            log("[a] device: gpu")
            log("[b] kernel vs XLA lockstep")
            phase_kernel(model, u8)
            log("[c] serve")
            phase_serve(model, u8, flt)
            log("[d] train")
            phase_train()
            stats = devs[0].memory_stats() or {}
            log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
