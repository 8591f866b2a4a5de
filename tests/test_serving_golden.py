"""The serving golden (tests/data/serving_golden.npz, written by
``python -m waldboost_tpu.golden``): the CPU path must keep reproducing it,
and on a GPU the compiled path must equal it bitwise."""

import numpy as np
import pytest

from waldboost_tpu.golden import (MODEL_PATH, box_rows_equal, golden_frames,
                                  load_golden, serving_boxes)


@pytest.fixture(scope="module")
def model():
    import waldboost_tpu as wb
    return wb.load(MODEL_PATH)


def _check(model, kind):
    u8, flt = golden_frames()
    frames = u8 if kind == "u8" else flt
    want, want_count = load_golden(kind)
    got, count = serving_boxes(model, frames)
    assert np.array_equal(count, want_count)
    assert (count >= 0).all()  # complete extraction: the golden is exact
    for g, w in zip(got, want):
        assert box_rows_equal(g, w)


@pytest.mark.parametrize("kind", ["u8", "float"])
def test_cpu_path_reproduces_golden(model, kind):
    _check(model, kind)


def test_golden_is_not_vacuous():
    want, count = load_golden("u8")
    assert sum(len(w) for w in want) > 50 and count.min() >= 0


@pytest.mark.gpu
def test_gpu_path_reproduces_golden(gpu, model):
    """uint8 frames: the zero-mismatch contract holds on the card too."""
    _check(model, "u8")
