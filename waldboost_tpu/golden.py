"""Serving golden: fixed VGA frames and the flagship detector's boxes on them.

The golden pins the serving path's output (boxes and scores after on-device
extraction and NMS) to what the CPU path computes, so a device can be held
to PARITY.md's zero-mismatch contract on uint8 frames.  ``python -m
waldboost_tpu.golden`` regenerates ``tests/data/serving_golden.npz``; the
CPU tests check that the CPU path still reproduces it, and ``chip_smoke.py``
checks the GPU against it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["GOLDEN_PATH", "MODEL_PATH", "golden_frames", "serving_boxes",
           "make_golden", "box_rows_equal"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(_ROOT, "tests", "data", "serving_golden.npz")
MODEL_PATH = os.path.join(_ROOT, "models", "flagship_synth_64.pb")
HW = (480, 640)
NMS_IOU = 0.5


def golden_frames(seed: int = 2024):
    """``(uint8 (6, 480, 640), float32 (2, 480, 640))``: four scene frames
    (utils.scene_generator) and two uniform-noise frames, plus two float
    frames (scene content with sub-integer noise)."""
    from .utils import scene_generator

    gen = scene_generator(seed=seed, hw=HW)
    scenes = [np.asarray(next(gen)["image"], np.uint8) for _ in range(4)]
    rng = np.random.RandomState(seed)
    noise = [rng.randint(0, 256, HW).astype(np.uint8) for _ in range(2)]
    u8 = np.stack(scenes + noise)
    flt = u8[:2].astype(np.float32) + rng.rand(2, *HW).astype(np.float32)
    return u8, flt


def serving_boxes(model, frames, k: int = 1024):
    """Per frame, the (n, 5) float32 rows ``[x1, y1, x2, y2, score]`` that
    ``make_batched_detector_boxes(model, (480, 640), nms_iou=0.5)`` keeps,
    in lexicographic row order, and the per-frame survivor counts."""
    import jax.numpy as jnp

    from .parallel.detect import make_batched_detector_boxes

    fn, _ = make_batched_detector_boxes(model, frames.shape[1:], k=k,
                                        nms_iou=NMS_IOU)
    rects, scores, valid, count, _ = (np.asarray(x)
                                      for x in fn(jnp.asarray(frames)))
    out = []
    for b in range(frames.shape[0]):
        sel = valid[b]
        rows = np.concatenate([rects[b][sel], scores[b][sel][:, None]],
                              axis=1).astype(np.float32)
        out.append(rows[np.lexsort(rows.T[::-1])])
    return out, count


def box_rows_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise equality of two sorted box-row arrays."""
    return a.shape == b.shape and np.array_equal(
        np.asarray(a, np.float32).view(np.int32),
        np.asarray(b, np.float32).view(np.int32))


def make_golden(path: str = GOLDEN_PATH) -> dict:
    """Compute the golden on the current backend and write it to ``path``."""
    from .model import Model

    model = Model.load(MODEL_PATH)
    u8, flt = golden_frames()
    data = {}
    for kind, frames in (("u8", u8), ("float", flt)):
        boxes, count = serving_boxes(model, frames)
        data[f"{kind}_count"] = np.asarray(count)
        for i, rows in enumerate(boxes):
            data[f"{kind}_{i}"] = rows
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **data)
    return data


def load_golden(kind: str, path: str = GOLDEN_PATH):
    """``([rows per frame], counts)`` of one frame kind ("u8" / "float")."""
    with np.load(path) as z:
        n = len(z[f"{kind}_count"])
        return [z[f"{kind}_{i}"] for i in range(n)], z[f"{kind}_count"]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    d = make_golden()
    print(GOLDEN_PATH, {k: v.shape for k, v in d.items()})
