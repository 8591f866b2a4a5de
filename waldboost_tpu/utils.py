"""Utilities: synthetic data generator, visualization, training callbacks.

Functional parity with /root/reference/waldboost/utils.py (the synthetic
generator's *random-draw sequence* is the de-facto hermetic dataset spec and
is preserved exactly); implementations are this package's own.  cv2 and
matplotlib import lazily so the core library has no hard viz dependencies.
"""

from __future__ import annotations

import numpy as np

from . import boxes as bbx
from . import groundtruth

__all__ = [
    "fake_data_generator",
    "scene_generator",
    "montage",
    "draw_detections",
    "ShowImageCallback",
    "class_prob_callback",
]

_SCENE_HW = (256, 256)


def _paint_scene(rng: np.random.RandomState):
    """One synthetic scene: up to one bright square over scaled noise.

    The random-draw order (object count; per object: side, x, y, intensity;
    then the noise field and its global gain) defines the dataset and must
    never change — trained-model goldens depend on the exact stream
    (/root/reference/waldboost/utils.py:81-97 is the original spec).
    """
    h, w = _SCENE_HW
    field = np.zeros((h, w), np.float32)
    rects = []
    for _ in range(rng.randint(2)):
        side = rng.randint(30, 60)
        x0 = rng.randint(w - side)
        y0 = rng.randint(h - side)
        gain = rng.uniform(0.2, 1)
        field[y0:y0 + side, x0:x0 + side] += gain
        # ground truth is the square dilated by 5 px, YXYX
        rects.append((y0 - 5, x0 - 5, y0 + side + 5, x0 + side + 5))
    field += rng.rand(h, w) * 0.3 * rng.rand()
    image = (np.clip(field, 0.0, 1.0) * 255).astype(np.uint8)
    rects = np.asarray(rects, np.float32) if rects else np.empty((0, 4))
    return image, rects


def fake_data_generator(seed=None):
    """Infinite synthetic dataset: bright squares on noise, 256x256 uint8,
    with YXYX ground truth.  Yields ``{"image", "groundtruth_boxes"}`` dicts
    (the actual ``wb.train`` input contract).  Unlike the reference, the
    stream is seedable (the reference drew from the global RNG)."""
    rng = np.random.RandomState(seed)
    while True:
        image, rects = _paint_scene(rng)
        gt = groundtruth.bbox_list(rects,
                                   format=groundtruth.RectFormat.YXYX)
        yield dict(image=np.atleast_2d(image), groundtruth_boxes=gt)


def scene_generator(seed=None, hw=(256, 256), max_objects=3, octaves=3,
                    base_side=18, aspect=(0.7, 1.45), p_ignore=0.15,
                    clutter=5, noise=0.3):
    """HARDER synthetic dataset than :func:`fake_data_generator`: bright
    rectangles spanning ``octaves`` octaves of size variation, variable
    aspect ratio, ignore-flagged instances, and textured un-annotated
    clutter over scaled noise.

    Designed to exercise the parts squares-on-noise never touches: the
    pyramid must match objects across scale
    octaves, the Evaluator's 'ignore' machinery sees real ignore-flagged
    ground truth (/root/reference/waldboost/testing.py:18-46), and the
    clutter patches (bright gradients/stripes that are NOT objects)
    populate the false-positive pool with structured negatives instead of
    pure noise.  Yields ``{"image", "groundtruth_boxes"}`` dicts with an
    'ignore' field; seedable like :func:`fake_data_generator` (the
    reference's generator spec is /root/reference/waldboost/utils.py:81-97;
    this one widens the distribution, it does not replace the hermetic
    fake_data_generator stream).
    """
    rng = np.random.RandomState(seed)
    h, w = hw
    while True:
        field = np.zeros((h, w), np.float32)
        rects, ignore = [], []
        # textured clutter: stripe/gradient patches, never annotated
        for _ in range(rng.randint(clutter + 1)):
            side = rng.randint(12, max(h, w) // 3)
            cw = max(int(side * rng.uniform(*aspect)), 4)
            y0 = rng.randint(max(h - side, 1))
            x0 = rng.randint(max(w - cw, 1))
            kind = rng.randint(3)
            amp = rng.uniform(0.1, 0.45)
            yy, xx = np.mgrid[0:side, 0:cw]
            if kind == 0:      # diagonal stripes
                tex = 0.5 * (1 + np.sin((xx + yy) * (2 * np.pi /
                                                     rng.randint(4, 16))))
            elif kind == 1:    # horizontal ramp
                tex = xx / max(cw - 1, 1)
            else:              # blob (radial falloff)
                cy, cx = side / 2, cw / 2
                tex = np.clip(1 - np.hypot(yy - cy, xx - cx)
                              / max(cy, cx), 0, 1)
            field[y0:y0 + side, x0:x0 + cw] += amp * tex.astype(np.float32)
        # objects: bright rectangles over 2-3 octaves of size
        for _ in range(rng.randint(max_objects + 1)):
            octv = rng.randint(octaves)
            side = int(base_side * 2 ** (octv + rng.uniform(0, 1)))
            ar = rng.uniform(*aspect)
            ow = max(int(side * ar), 6)
            if side >= h - 1 or ow >= w - 1:
                continue
            y0 = rng.randint(h - side)
            x0 = rng.randint(w - ow)
            gain = rng.uniform(0.25, 1)
            field[y0:y0 + side, x0:x0 + ow] += gain
            rects.append((x0 - 5, y0 - 5, x0 + ow + 5, y0 + side + 5))
            # truncated/marginal instances are flagged ignore: detections
            # there neither count as hits nor as false positives
            ignore.append(1 if rng.rand() < p_ignore else 0)
        field += rng.rand(h, w) * noise * rng.rand()
        image = (np.clip(field, 0.0, 1.0) * 255).astype(np.uint8)
        rects = np.asarray(rects, np.float32) if rects \
            else np.empty((0, 4), np.float32)
        gt = bbx.Boxes(rects, ignore=np.asarray(ignore, np.int32)
                       if ignore else np.empty(0, np.int32))
        yield dict(image=image, groundtruth_boxes=gt)


def montage(X, nrows=4, ncols=4, figsize=None):
    """Grid plot of up to ``nrows * ncols`` sample windows, shared gray
    scale clipped at the 99th percentile."""
    import matplotlib.pyplot as plt

    X = np.asarray(X)
    if figsize is None:
        h, w = X.shape[1:3]
        figsize = (15, 15 * (h * nrows) / max(w * ncols, 1))
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    top = np.percentile(X, 99)
    for ax, idx in zip(axes.ravel(), range(nrows * ncols)):
        ax.set_axis_off()
        if idx < len(X):
            ax.imshow(np.squeeze(X[idx]), cmap="gray", vmax=top)
    plt.show()
    return fig


def _score_palette(scores, vmin, vmax):
    """uint8 BGR-ish palette rows for each score via the plasma colormap."""
    import matplotlib as mpl
    from matplotlib import cm

    lo = float(np.min(scores)) if vmin is None else vmin
    hi = float(np.max(scores)) if vmax is None else vmax
    norm = mpl.colors.Normalize(vmin=lo, vmax=hi)
    rgba = cm.plasma(norm(np.asarray(scores, np.float64)))
    return np.uint8(np.round(255.0 * rgba))


def draw_detections(image, dt_boxes, gt_boxes=None, *, dt_thickness=1,
                    gt_thickness=1, gt_color=(255, 0, 0), vmin=None,
                    vmax=None):
    """Render detections (score-colored, low scores drawn first so strong
    ones stay on top) and optional ground truth onto a copy of ``image``.
    Returns an RGB array."""
    import cv2

    canvas = np.asarray(image).copy()
    if canvas.ndim == 2:
        canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)

    if gt_boxes is not None:
        for rect in np.asarray(gt_boxes.get(), np.int32):
            cv2.rectangle(canvas, tuple(rect[:2]), tuple(rect[2:]),
                          gt_color, thickness=gt_thickness)

    if dt_boxes is not None and len(dt_boxes):
        ordered = bbx.sort_by_field(dt_boxes, "scores", descending=False)
        palette = _score_palette(ordered.get_field("scores"), vmin, vmax)
        for rect, color in zip(np.asarray(ordered.get(), np.int32), palette):
            cv2.rectangle(canvas, tuple(rect[:2]), tuple(rect[2:]),
                          tuple(int(c) for c in color),
                          thickness=dt_thickness)

    return canvas[..., ::-1]


class ShowImageCallback:
    """Training callback: once the cumulative fpr drops under ``max_fpr``,
    run the model on a held-out image and display the detections."""

    def __init__(self, image, gt_boxes, max_fpr=0.05):
        self.image = image
        self.gt = gt_boxes
        self.max_fpr = max_fpr

    def __call__(self, model, learner, stage):
        import cv2

        if learner.false_positive_rate >= self.max_fpr:
            return
        rendered = draw_detections(self.image, model.detect(self.image),
                                   self.gt, gt_thickness=3,
                                   gt_color=(255, 0, 0))
        cv2.imshow("Testing image", rendered)
        cv2.waitKey(20)


def class_prob_callback(model, learner, stage):
    print(f"Stage {stage}:")
    print(f"\tp0 = {learner.false_positive_rate:.5f}; "
          f"p1 = {learner.true_positive_rate:.5f}")
