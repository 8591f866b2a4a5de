"""Measured CPU-reference baselines for the bench.py configs 1-5.

Runs the reference (RomanJuranek/waldboost, imported under
tests/refshims — numba is absent from this image, but every reference
kernel is internally *vectorized NumPy* under njit/stencil, so the shimmed
run is honest NumPy-speed; see tests/refshims/numba/__init__.py) on the
same workloads bench.py measures on the device, and record per config:

  - megapixels/second (same uniform-noise uint8 frames as bench.py)
  - windows scored per second (Model.n_loc counter)
  - eval_cost (average weak evaluations per window, the reference's own
    cascade diagnostic, /root/reference/waldboost/model.py:69-89)
  - stages/min for the training loop (config 4)

Usage (CPU; the models are built by the same helpers bench.py uses):

    python scripts/bench_reference.py            # all configs
    BENCH_REF_CONFIGS=vga_full python scripts/bench_reference.py

Results are printed as one JSON line per config.
"""

import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _import_reference():
    """Import /root/reference/waldboost under the test shims (numba/skimage/
    bbx stand-ins + NumPy-2 compat aliases + our wire-compatible pb2)."""
    for name, val in [("bool", bool), ("int", int), ("float", float)]:
        if name not in np.__dict__:
            setattr(np, name, val)
    for p in (os.path.join(REPO, "tests", "refshims"), "/root/reference"):
        if p not in sys.path:
            sys.path.insert(0, p)
    import waldboost_tpu.proto.model_pb2 as pb2
    sys.modules.setdefault("waldboost.model_pb2", pb2)
    import waldboost as ref
    return ref


def _ref_model_from(model, ref, channels_func):
    """Move one of our models into a reference Model via the wire format.

    The proto is parsed with our (wire-compatible) pb2 and the reference
    Model is assembled directly, binding the channel function to the
    REFERENCE's own implementation — Model.load's symbol_from_name would
    resolve our registry aliases (and cannot resolve composite names like
    'grad_hist_4_u1+grad_mag_u1' at all)."""
    import zlib

    from waldboost_tpu.proto import model_pb2

    path = "/tmp/bench_ref_model.pb"
    model.save(path)
    proto = model_pb2.Model()
    with open(path, "rb") as f:
        data = f.read()
    try:
        proto.ParseFromString(zlib.decompress(data))
    except zlib.error:
        proto.ParseFromString(data)
    opts = dict(shrink=proto.channel_opts.shrink,
                n_per_oct=proto.channel_opts.n_per_oct,
                smooth=proto.channel_opts.smooth,
                channels=channels_func)
    rmodel = ref.Model(tuple(proto.shape), opts)
    for weak_proto, theta in zip(proto.classifier, proto.theta):
        rmodel.append(ref.training.DTree.from_proto(weak_proto), theta)
    return rmodel


def _noise_frames(h, w, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w)).astype(np.uint8) for _ in range(n)]


def _detect_mps(rmodel, h, w, frames, warmup=1):
    """Reference detect + NMS throughput on noise frames (bench.py's
    serving contract: boxes out, NMS on)."""
    import bbx

    for f in frames[:warmup]:
        boxes = rmodel.detect(f)
        bbx.non_max_suppression(boxes, iou_threshold=0.5)
    rmodel.reset()
    timed = frames[warmup:]
    t0 = time.perf_counter()
    for f in timed:
        boxes = rmodel.detect(f)
        bbx.non_max_suppression(boxes, iou_threshold=0.5)
    dt = time.perf_counter() - t0
    return {
        "mps": h * w / 1e6 * len(timed) / dt,
        "windows_per_s": rmodel.n_loc / dt,
        "eval_cost": rmodel.eval_cost,
        "frames": len(timed),
        "s_per_frame": dt / len(timed),
    }


def bench_vga_single_scale(ref, frames=6):
    """Config 1: 64-stage stump model, VGA, ONE pyramid scale (the first
    level of the reference's own channel iterator)."""
    from __graft_entry__ import _flagship_model

    rmodel = _ref_model_from(_flagship_model(n_stages=64, depth=1), ref,
                             ref.channels.grad_hist)
    h, w = 480, 640
    fs = _noise_frames(h, w, frames + 1)
    chns, _scale = next(rmodel.channels(fs[0]))
    rmodel.predict_on_image(chns)  # warmup
    rmodel.reset()
    t0 = time.perf_counter()
    for f in fs[1:]:
        chns, _scale = next(rmodel.channels(f))
        rmodel.predict_on_image(chns)
    dt = time.perf_counter() - t0
    return {"mps": h * w / 1e6 * frames / dt,
            "windows_per_s": rmodel.n_loc / dt,
            "eval_cost": rmodel.eval_cost,
            "frames": frames, "s_per_frame": dt / frames}


def bench_vga_full_pyramid(ref, frames=6):
    """Config 2 (the headline): trained 64-stage flagship, full
    shrink=2/n_per_oct=8/smooth=1 pyramid + NMS."""
    import waldboost_tpu as wb

    model = wb.load(os.path.join(REPO, "models", "flagship_synth_64.pb"))
    rmodel = _ref_model_from(model, ref, ref.channels.grad_hist)
    return _detect_mps(rmodel, 480, 640, _noise_frames(480, 640, frames + 1))


def bench_synthetic_calibrated(ref, frames=6):
    """Config 2b: the synthetic quantile-calibrated diagnostic cascade."""
    from __graft_entry__ import _flagship_model

    rmodel = _ref_model_from(_flagship_model(), ref, ref.channels.grad_hist)
    return _detect_mps(rmodel, 480, 640, _noise_frames(480, 640, frames + 1))


def bench_fhd_stream(ref, frames=3):
    """Config 3: depth-2 trees on 1080p frames."""
    from __graft_entry__ import _flagship_model

    rmodel = _ref_model_from(_flagship_model(image_hw=(540, 960)), ref,
                             ref.channels.grad_hist)
    return _detect_mps(rmodel, 1080, 1920, _noise_frames(1080, 1920,
                                                         frames + 1))


def bench_fpga_4k(ref, frames=2, smooth=0):
    """Config 5: FPGA integer channels (grad_hist_4_u1 + grad_mag_u1,
    C=5) on 4K frames."""
    from __graft_entry__ import _flagship_model

    def channels(im):
        from waldboost.fpga import grad_hist_4_u1, grad_mag_u1
        return np.concatenate([np.atleast_3d(grad_hist_4_u1(im)),
                               np.atleast_3d(grad_mag_u1(im))], axis=2)

    opts = dict(shrink=2, n_per_oct=4, smooth=smooth,
                channels="grad_hist_4_u1+grad_mag_u1")
    model = _flagship_model(channel_opts=opts, image_hw=(540, 960),
                            shape=(12, 12, 5))
    rmodel = _ref_model_from(model, ref, channels)
    return _detect_mps(rmodel, 2160, 3840,
                       _noise_frames(2160, 3840, frames + 1))


def bench_train_loop(ref, n_stages=6):
    """Config 4: reference training loop, stages/min (same synthetic
    stream and learner config as bench.py's config 4; stage 0-1 excluded
    as loop warmup exactly like the device measurement)."""
    from waldboost_tpu.utils import fake_data_generator

    def gen():
        for d in fake_data_generator(seed=11):
            gt = d["groundtruth_boxes"]
            yield dict(image=d["image"],
                       groundtruth_boxes=gt if len(gt) else None)

    g = gen()
    rmodel = ref.Model((12, 12, 4), dict(shrink=2, n_per_oct=4, smooth=1,
                                         channels=ref.channels.grad_hist))
    learner = ref.training.Learner(alpha=0.2, max_depth=2)
    pool = ref.SamplePool(min_tp=1000, min_fp=1000)
    ref.train(rmodel, g, pool=pool, learner=learner, length=2)
    t0 = time.perf_counter()
    ref.train(rmodel, g, pool=pool, learner=learner, length=2 + n_stages)
    dt = time.perf_counter() - t0
    return {"stages_per_min": n_stages / dt * 60.0, "stages": n_stages,
            "s_per_stage": dt / n_stages}


def main():
    ref = _import_reference()
    only = os.environ.get("BENCH_REF_CONFIGS", "all")
    configs = [
        ("vga_single_scale_reference", bench_vga_single_scale),
        ("vga_full_pyramid_reference", bench_vga_full_pyramid),
        ("synthetic_calibrated_reference", bench_synthetic_calibrated),
        ("fhd_depth2_stream_reference", bench_fhd_stream),
        ("fpga_4k_quantized_reference", bench_fpga_4k),
        ("fpga_4k_smooth_reference",
         lambda r: bench_fpga_4k(r, smooth=1)),
        ("training_loop_reference", bench_train_loop),
    ]
    for name, fn in configs:
        if only != "all" and name not in only:
            continue
        t0 = time.perf_counter()
        try:
            res = fn(ref)
        except Exception as e:  # record the failure, keep measuring
            res = {"error": repr(e)}
        res = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in res.items()}
        res.update(metric=name, wall_s=round(time.perf_counter() - t0, 1))
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
