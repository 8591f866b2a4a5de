"""Throughput benchmarks of the detector and trainer on one device.

Prints the device (platform, kind, count, and the card's name and power
limit from nvidia-smi), then one JSON line per config ({"metric", "value",
"unit", "device"}); the headline config — VGA full-pyramid detection —
prints last.  Exits nonzero when any config fails.  Batch sizes are not yet
tuned for the current card.

``BENCH_CONFIGS`` selects configs by name; ``WALDBOOST_TPU_CASCADE=xla``
times the XLA lockstep cascade instead of the GPU kernel.

Configs:
  1. vga_single_scale — 12x12x4 grad_hist stump model, 640x480, one scale
  2. vga_full_pyramid — shrink=2/n_per_oct=8/smooth=1 pyramid, 64-stage
     depth-2 cascade, on-device box extraction + NMS  [HEADLINE].  The
     headline cascade is the committed REALLY-TRAINED flagship
     (models/flagship_synth_64.pb, scripts/train_flagship.py — AUC 0.903
     on the held-out synthetic corpus): a detector framework's honest
     number runs under real trained rejection dynamics.  The synthetic
     quantile-calibrated cascade that headlined rounds 1-2 stays as the
     `synthetic_calibrated_throughput` diagnostic (training-independent
     kernel regression tracking).
  3. fhd_stream_depth2 — depth-2 trees, batched 1920x1080 stream
  4. train_loop — SamplePool + Learner.fit_stage (alpha=0.2), synthetic data
  5. fpga_4k — quantized integer channels, multi-channel
     grad_hist_4_u1+grad_mag_u1 (C=5), 3840x2160, NMS on; plus a smooth=1
     variant (fpga_4k_smooth)

Every iteration uses distinct inputs; each timed segment ends in
``block_until_ready`` on the last result.  A rate is all the work of all
timed segments over their total time; each segment's time goes to stderr.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np


def _device():
    """(platform, device_kind, count) as JAX reports them."""
    import jax
    devs = jax.devices()
    return devs[0].platform, devs[0].device_kind, len(devs)


def _card():
    """The card's name and power limit, or why they are unknown."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"


def _segments(label, times):
    """Report every timed segment on stderr (stalls stay visible) and
    return their total."""
    print(f"{label}: segments {[round(t, 6) for t in times]} s",
          file=sys.stderr, flush=True)
    return float(np.sum(times))


def _timeit(fn, batches, iters, warmup, reps=1):
    """Time ``reps`` segments of ``iters`` dispatches each (every dispatch
    a distinct input) and return the TOTAL time of all segments; each
    segment ends when the device has finished its last result."""
    import jax
    for i in range(warmup):
        jax.block_until_ready(fn(batches[i]))
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        last = None
        for i in range(iters):
            last = fn(batches[warmup + r * iters + i])
        jax.block_until_ready(last)
        times.append(time.perf_counter() - t0)
    return _segments("detect", times)


def _detect_mps(model, h, w, batch, iters, warmup, nms_iou=None, k=128,
                k_row=16, reps=1, frames=None, fast=False, as_float=False):
    """End-to-end batched detection throughput: channels + cascade +
    on-device box extraction (+ optional on-device NMS).

    ``frames``: optional (N, h, w) uint8 pool of frames to cycle through
    (default: fresh uniform noise per dispatch).  ``fast``: build the
    detector under WB_SERVING_MODE=fast (the opt-in non-bit-exact mode;
    the env is resolved at build time)."""
    import jax
    import jax.numpy as jnp

    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    # with_n_weak=False: serving parity with the reference's detect (boxes +
    # scores only; the evaluation counter is an eval_cost diagnostic)
    prev = os.environ.get("WB_SERVING_MODE")
    if fast:
        os.environ["WB_SERVING_MODE"] = "fast"
    try:
        fn, _ = make_batched_detector_boxes(model, (h, w), k=k, k_row=k_row,
                                            nms_iou=nms_iou,
                                            with_n_weak=False)
    finally:
        if fast:
            if prev is None:
                os.environ.pop("WB_SERVING_MODE", None)
            else:
                os.environ["WB_SERVING_MODE"] = prev

    # one jitted reduce forces every output without transferring it
    @jax.jit
    def _force(rects, valid, count):
        return (valid.sum().astype(jnp.float32) + rects.sum()
                + count.sum().astype(jnp.float32))

    def run(images):
        rects, scores, valid, count, _ = fn(images)
        return _force(rects, valid, count)

    rng = np.random.RandomState(0)
    n_batches = iters * reps + warmup
    idt = np.float32 if as_float else np.uint8
    if frames is None:
        batches = [
            jnp.asarray(rng.randint(0, 256, (batch, h, w)).astype(idt))
            for _ in range(n_batches)
        ]
    else:
        # cycle the frame pool with a distinct rotation per batch
        N = frames.shape[0]
        batches = []
        for i in range(n_batches):
            idx = (np.arange(batch) * 7 + i * 13) % N
            batches.append(jnp.asarray(frames[idx]))
    dt = _timeit(run, batches, iters, warmup, reps=reps)
    return h * w / 1e6 * batch * iters * reps / dt


def bench_vga_single_scale(batch, iters, warmup, reps=1):
    """Config 1: stump model, single 640x480 image, ONE pyramid scale.

    Runs the serving pipeline capped at the first pyramid level
    (make_batched_detector_boxes(n_scales=1) — exact vs the reference-
    style predict_on_image on the first channel_pyramid scale,
    tests/test_parallel.py::test_n_scales_capped_detector_matches_first_scale)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_model
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes

    h, w = 480, 640
    model = _flagship_model(n_stages=64, depth=1)
    fn, _ = make_batched_detector_boxes(model, (h, w), k=128,
                                        with_n_weak=False, n_scales=1)

    @jax.jit
    def _force(rects, valid, count):
        return (valid.sum().astype(jnp.float32) + rects.sum()
                + count.sum().astype(jnp.float32))

    def run(images):
        rects, scores, valid, count, _ = fn(images)
        return _force(rects, valid, count)

    rng = np.random.RandomState(0)
    batches = [
        jnp.asarray(rng.randint(0, 256, (batch, h, w)).astype(np.uint8))
        for _ in range(iters * reps + warmup)
    ]
    dt = _timeit(run, batches, iters, warmup, reps=reps)
    return h * w / 1e6 * batch * iters * reps / dt


def bench_vga_full_pyramid(batch, iters, warmup, reps=1):
    """Config 2 (HEADLINE): full pyramid + the committed trained 64-stage
    depth-2 cascade + on-device extraction + NMS."""
    import waldboost_tpu as wb

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models", "flagship_synth_64.pb")
    model = wb.load(path)
    return _detect_mps(model, 480, 640, batch, iters, warmup, nms_iou=0.5,
                       reps=reps)


def bench_vga_full_pyramid_fast(batch, iters, warmup, reps=1):
    """Config 2, WB_SERVING_MODE=fast: the opt-in serving mode with a bf16
    canvas (no exactness contract).  Same trained flagship, same
    pipeline."""
    import waldboost_tpu as wb

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models", "flagship_synth_64.pb")
    model = wb.load(path)
    return _detect_mps(model, 480, 640, batch, iters, warmup, nms_iou=0.5,
                       reps=reps, fast=True)


def bench_float_image_fast(batch, iters, warmup, reps=1):
    """Config 2f: float32 frames under WB_SERVING_MODE=fast: plain f32
    channel chains instead of the double-float contract
    (polyphase._combine_block_plain)."""
    import waldboost_tpu as wb

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models", "flagship_synth_64.pb")
    model = wb.load(path)
    return _detect_mps(model, 480, 640, batch, iters, warmup, nms_iou=0.5,
                       reps=reps, fast=True, as_float=True)


def _scene_frames(n=64, hw=(480, 640), seed=100):
    """Fixed seeded corpus of OBJECT-BEARING VGA frames (multi-scale
    rectangles + clutter, utils.scene_generator): noise frames reward
    rejection aggressiveness; scene frames measure the detector doing
    work."""
    from waldboost_tpu.utils import scene_generator
    gen = scene_generator(seed=seed, hw=hw)
    return np.stack([next(gen)["image"] for _ in range(n)])


def bench_scene_frames(batch, iters, warmup, reps=1):
    """Config 2s: the trained flagship on scene frames (objects present)."""
    import waldboost_tpu as wb

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "models", "flagship_synth_64.pb")
    model = wb.load(path)
    return _detect_mps(model, 480, 640, batch, iters, warmup, nms_iou=0.5,
                       reps=reps, frames=_scene_frames())


def bench_synthetic_calibrated(batch, iters, warmup, reps=1):
    """Config 2 diagnostic: the synthetic quantile-calibrated cascade of
    __graft_entry__ (random trees over real channel statistics, survivor-
    quantile thetas) on the same VGA full-pyramid pipeline — tracks kernel
    regressions independently of any training run."""
    from __graft_entry__ import _flagship_model
    model = _flagship_model()
    return _detect_mps(model, 480, 640, batch, iters, warmup, nms_iou=0.5,
                       reps=reps)


def bench_fhd_stream_depth2(batch, iters, warmup, reps=1):
    """Config 3: depth-2 trees over 1080p image streams."""
    from __graft_entry__ import _flagship_model
    model = _flagship_model(image_hw=(540, 960))
    return _detect_mps(model, 1080, 1920, batch, iters, warmup, nms_iou=0.5,
                       reps=reps)


def bench_fpga_4k(batch, iters, warmup, smooth=0, reps=1):
    """Config 5: FPGA quantized integer
    channels + multi-channel (grad_hist_4_u1 + grad_mag_u1, C=5) on 4K
    frames, NMS on.  ``smooth=1`` additionally measures the in-kernel
    3x3/16 smooth variant (the full reference channel contract)."""
    from __graft_entry__ import _flagship_model
    opts = dict(shrink=2, n_per_oct=4, smooth=smooth,
                channels="grad_hist_4_u1+grad_mag_u1")
    model = _flagship_model(channel_opts=opts, image_hw=(540, 960),
                            shape=(12, 12, 5))
    return _detect_mps(model, 2160, 3840, batch, iters, warmup, nms_iou=0.5,
                       reps=reps)


def bench_train_loop(n_stages=6, reps=1):
    """Config 4: WaldBoost training-loop throughput (stages/min) on the
    synthetic dataset — pool mining + device histogram tree fit + SPRT
    (the HOST-pool reference-parity path), over ``reps`` segments of
    ``n_stages`` each."""
    import waldboost_tpu as wb
    from waldboost_tpu.utils import fake_data_generator

    gen = fake_data_generator(seed=11)
    model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                       channels="grad_hist"))
    pool = wb.SamplePool(min_tp=1000, min_fp=1000, seed=0)
    learner = wb.Learner(alpha=0.2, max_depth=2)
    # stage 0 pays all compilation; time the steady-state stages
    wb.train(model, gen, pool=pool, learner=learner, length=2)
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        wb.train(model, gen, pool=pool, learner=learner,
                 length=2 + (r + 1) * n_stages)
        times.append(time.perf_counter() - t0)
    return n_stages * reps / _segments("train", times) * 60.0


def bench_train_loop_device_pool(n_stages=12, reps=1):
    """Config 4b: the device-pool trainer (device-resident sample pool, the
    whole numeric stage as one program, batched+prefetched mining with
    bit-packed survivor maps) — wb.train's mesh path on one device."""
    import waldboost_tpu as wb
    from waldboost_tpu.parallel.trainer import train_sharded
    from waldboost_tpu.utils import fake_data_generator

    gen = fake_data_generator(seed=11)
    model = wb.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                       channels="grad_hist"))
    learner = wb.Learner(alpha=0.2, max_depth=2)
    from waldboost_tpu.io import prefetch_iterable
    gen = prefetch_iterable(gen, depth=32)
    # the pools dict carries the device-resident pool across segments —
    # the same steady-state contract as the host-pool config, which reuses
    # its SamplePool (a fresh pool per segment would re-measure bootstrap
    # mining, not the training loop)
    pools = {}
    # the warmup segment prewarms every length bucket the measured
    # segments will cross (its end-of-call join absorbs the compiles)
    train_sharded(model, gen, mesh=None, learner=learner, length=2,
                  min_tp=1000, min_fp=1000, seed=0, pools=pools,
                  prewarm_length=2 + reps * n_stages)
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        train_sharded(model, gen, mesh=None, learner=learner,
                      length=2 + (r + 1) * n_stages,
                      min_tp=1000, min_fp=1000, seed=0, pools=pools)
        times.append(time.perf_counter() - t0)
    return n_stages * reps / _segments("train", times) * 60.0


def main():
    only = os.environ.get("BENCH_CONFIGS", "all")
    platform, kind, count = _device()
    device = {"platform": platform, "kind": kind, "count": count}
    print(_card(), flush=True)
    print(json.dumps({"device": device}), flush=True)
    # batch sizes: not yet tuned for this card
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    iters = int(os.environ.get("BENCH_ITERS", "16"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    warmup = 2
    failed = []

    def add(name, fn, unit="MP/s"):
        if only != "all" and name not in only.split(","):
            return
        try:
            value = fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            return
        # print at once: a later failing config must not lose this one
        print(json.dumps({"metric": name, "value": value, "unit": unit,
                          "device": device}), flush=True)

    ss_batch = int(os.environ.get("BENCH_BATCH_SINGLE", "64"))
    add("single_scale_detection_throughput",
        lambda: bench_vga_single_scale(ss_batch, iters, warmup, reps=reps))
    fhd_batch = int(os.environ.get("BENCH_BATCH_FHD", "8"))
    fpga_batch = int(os.environ.get("BENCH_BATCH_4K", "4"))
    add("fhd_depth2_stream_throughput",
        lambda: bench_fhd_stream_depth2(fhd_batch, iters, warmup,
                                        reps=reps))
    add("fpga_4k_quantized_throughput",
        lambda: bench_fpga_4k(fpga_batch, max(iters // 2, 2),
                              warmup, reps=reps))
    add("fpga_4k_smooth_throughput",
        lambda: bench_fpga_4k(fpga_batch, max(iters // 2, 2),
                              warmup, smooth=1, reps=reps))
    add("training_loop_throughput",
        lambda: bench_train_loop(reps=min(reps, 2)), unit="stages/min")
    add("training_loop_device_pool",
        lambda: bench_train_loop_device_pool(reps=min(reps, 2)),
        unit="stages/min")
    add("synthetic_calibrated_throughput",
        lambda: bench_synthetic_calibrated(batch, iters, warmup, reps=reps))
    add("scene_frame_detection_throughput",
        lambda: bench_scene_frames(batch, iters, warmup, reps=reps))
    add("full_pyramid_fast_throughput",
        lambda: bench_vga_full_pyramid_fast(batch, iters, warmup,
                                            reps=reps))
    add("float_image_fast_throughput",
        lambda: bench_float_image_fast(batch, iters, warmup, reps=reps))
    # headline last
    add("full_pyramid_detection_throughput",
        lambda: bench_vga_full_pyramid(batch, iters, warmup, reps=reps))
    if failed:
        print(f"failed configs: {failed}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
