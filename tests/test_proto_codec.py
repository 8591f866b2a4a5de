"""The pure-Python proto3 codec of model.proto: round trips, byte equality
with protoc-generated bindings, the shipped models, malformed input."""

import glob
import os
import zlib

import numpy as np
import pytest

import waldboost_tpu as wb
from waldboost_tpu.proto import codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = sorted(glob.glob(os.path.join(ROOT, "models", "*.pb")))


def _sample():
    m = codec.Model()
    m.shape.extend([12, 12, 4])
    m.channel_opts.shrink = 2
    m.channel_opts.n_per_oct = 8
    m.channel_opts.smooth = 1
    m.channel_opts.func = "waldboost_tpu.channels.grad_hist"
    t = m.classifier.add()
    t.feature.extend([1, 2, 3, -1, -1, -1, -1, -1, -1])
    t.threshold.extend([0.5, 0.0, 0.0])
    t.left.extend([1, -1, -1])
    t.right.extend([2, -1, -1])
    t.prediction.extend([0.0, -0.25, 0.75])
    m.theta.extend([-np.inf])
    return m


def test_codec_round_trip():
    m = _sample()
    data = m.SerializeToString()
    m2 = codec.Model()
    m2.ParseFromString(data)
    assert m2 == m
    assert m2.SerializeToString() == data
    assert list(m2.classifier[0].feature)[3:] == [-1] * 6
    assert m2.theta[0] == -np.inf


def test_codec_bytes_equal_protoc_bindings():
    pytest.importorskip("google.protobuf")
    import model_pb2  # the protoc-generated bindings, kept as an oracle

    m = _sample()
    ref = model_pb2.Model()
    ref.ParseFromString(m.SerializeToString())
    assert ref.SerializeToString() == m.SerializeToString()
    assert list(ref.classifier[0].left) == [1, -1, -1]
    # and a model saved by the package parses identically with both
    model = wb.load(MODELS[0])
    pb = model_pb2.Model()
    model.as_proto(pb)
    cm = codec.Model()
    model.as_proto(cm)
    assert pb.SerializeToString() == cm.SerializeToString()


@pytest.mark.parametrize("path", MODELS, ids=os.path.basename)
def test_shipped_models_decode_and_reencode(path, tmp_path):
    raw = zlib.decompress(open(path, "rb").read())
    m = codec.Model()
    m.ParseFromString(raw)
    assert list(m.shape) == [12, 12, 4] and len(m.classifier) in (64, 256)
    assert m.SerializeToString() == raw
    model = wb.load(path)
    out = tmp_path / "m.pb"
    model.save(str(out))
    assert zlib.decompress(out.read_bytes()) == raw


def test_codec_accepts_unpacked_and_unknown_fields():
    # shape as unpacked varints (field 1, wire type 0) + an unknown field 9
    data = bytes([0x08, 12, 0x08, 12, 0x08, 4, 0x48, 7])
    m = codec.Model()
    m.ParseFromString(data)
    assert list(m.shape) == [12, 12, 4]


@pytest.mark.parametrize("data", [
    b"\x0a\x05\x01",          # packed field longer than the message
    b"\x08",                  # truncated varint
    b"\x0b\x00",              # wire type 3 (groups) is not proto3
    b"\x12\x03\x2a\x01\xff",  # channel_opts.func with invalid UTF-8
])
def test_codec_rejects_malformed(data):
    with pytest.raises(ValueError):
        codec.Model().ParseFromString(data)


def test_load_corrupt_file_raises_value_error(tmp_path):
    bad = tmp_path / "bad.pb"
    bad.write_bytes(zlib.compress(b"\x0b\x00"))
    with pytest.raises(ValueError, match="Cannot read model"):
        wb.load(str(bad))
    bad.write_bytes(b"not zlib at all")
    with pytest.raises(ValueError, match="Cannot read model"):
        wb.load(str(bad))
