"""Native data-loading runtime: C++ prefetching loader + bbGt parsing.

The C++ library (``native/loader.cpp``) provides the host-side input
pipeline: worker threads decode (image, ground-truth) pairs into a bounded
queue while the device computes — this framework's replacement for the
reference CLI's per-image ``multiprocessing.Pool`` fan-out
(/root/reference/scripts/waldboost-detect.py:65-67).

The library is compiled on first use with g++ (cached beside the source);
pure-Python fallbacks keep everything working without a toolchain.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..boxes import Boxes

logger = logging.getLogger(__name__)

__all__ = ["native_available", "read_bbgt_native", "load_pnm_gray",
           "PrefetchDataset", "bbgt_dataset_paths", "bbgt_training_stream",
           "prefetch_iterable", "Prefetcher"]


def prefetch_iterable(iterable, depth: int = 16):
    """Background-thread prefetch of any record iterable.

    A daemon thread drains ``iterable`` into a bounded queue (``depth``
    records deep) so the producer — a decoding generator, a dataset loader —
    runs WHILE the device computes, instead of serially between dispatches.
    Record order is preserved exactly; producer exceptions re-raise at the
    consumer.  (The python-generator analog of the native
    :class:`PrefetchDataset`; wb.train wires it around training_images.)
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    END = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
            q.put(END)
        except BaseException as e:  # propagate into the consumer
            q.put((END, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is END:
            raise item[1]
        yield item


class Prefetcher:
    """Stoppable background-thread record prefetcher.

    Like :func:`prefetch_iterable`, but the producer can be halted WITHOUT
    losing records: :meth:`stop` joins the worker thread and returns every
    record already pulled from the source but not yet consumed, in order.
    wb.train uses this so a finite generator reused across train() calls
    sees no dropped records (the reference's generator contract,
    /root/reference/waldboost/__init__.py:151-156, pulls lazily and loses
    nothing between calls).
    """

    _END = object()

    def __init__(self, iterable, depth: int = 16):
        import queue
        import threading

        self._queue_mod = queue
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._halt = threading.Event()
        self._overflow: list = []   # in-flight record when stop raced a put
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(iterable,), daemon=True)
        self._thread.start()

    def _worker(self, iterable) -> None:
        queue = self._queue_mod
        try:
            for item in iterable:
                while True:
                    if self._halt.is_set():
                        self._overflow.append(item)
                        return
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate into the consumer
            self._exc = e
        # Unconditional sentinel: consumers unblock, stop() drops it.
        while True:
            if self._halt.is_set():
                return
            try:
                self._q.put(self._END, timeout=0.05)
                return
            except queue.Full:
                continue

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._exc is not None:
                    exc, self._exc = self._exc, None
                    raise exc
                return
            yield item

    def stop(self) -> list:
        """Halt the producer; return unconsumed records in source order."""
        self._halt.set()
        self._thread.join()
        residue = []
        while not self._q.empty():
            item = self._q.get_nowait()
            if item is not self._END:
                residue.append(item)
        residue.extend(self._overflow)
        self._overflow = []
        return residue

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "_loader.so")
_LIB = None
_TRIED = False


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "loader.cpp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           src, "-o", _SO_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # pragma: no cover - toolchain-dependent
        logger.warning("native loader build failed: %s", e)
        return False


def _get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        src = os.path.join(_NATIVE_DIR, "loader.cpp")
        if not (os.path.exists(src) and _build()):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:  # pragma: no cover
        logger.warning("native loader load failed: %s", e)
        return None
    lib.wb_bbgt_parse_file.restype = ctypes.c_int
    lib.wb_bbgt_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.wb_load_pnm_gray.restype = ctypes.c_int
    lib.wb_load_pnm_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.wb_prefetcher_create.restype = ctypes.c_void_p
    lib.wb_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.wb_prefetcher_next.restype = ctypes.c_int
    lib.wb_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64)]
    lib.wb_prefetcher_destroy.restype = None
    lib.wb_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def read_bbgt_native(filename: str, cap: int = 4096) -> Boxes:
    """bbGt reader backed by the C++ parser (falls back to the Python
    implementation in waldboost_tpu.groundtruth)."""
    lib = _get_lib()
    if lib is None:
        from ..groundtruth import read_bbgt
        return read_bbgt(filename)
    rects = np.zeros((cap, 4), np.float32)
    ignore = np.zeros(cap, np.int32)
    n = lib.wb_bbgt_parse_file(
        filename.encode(), rects.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ignore.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap)
    if n == -1:
        raise IOError(f"cannot read {filename}")
    if n < 0:
        raise ValueError(f"invalid bbGt file {filename} (code {n})")
    n = min(n, cap)
    return Boxes(rects[:n], ignore=ignore[:n].copy())


def load_pnm_gray(filename: str, max_pixels: int = 1 << 24) -> np.ndarray:
    """Decode a P5/P6 PNM file to (H, W) uint8 via the native decoder."""
    lib = _get_lib()
    if lib is None:
        from PIL import Image
        return np.asarray(Image.open(filename).convert("L"))
    buf = np.zeros(max_pixels, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.wb_load_pnm_gray(
        filename.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_pixels, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"cannot decode {filename} (code {rc})")
    return buf[:h.value * w.value].reshape(h.value, w.value).copy()


def bbgt_dataset_paths(image_dir: str, annotation_dir: str,
                       image_ext: str = ".pgm", ann_ext: str = ".txt"):
    """Pair up image files with same-stem bbGt annotation files."""
    imgs = sorted(f for f in os.listdir(image_dir) if f.endswith(image_ext))
    img_paths, ann_paths = [], []
    for f in imgs:
        stem = os.path.splitext(f)[0]
        ann = os.path.join(annotation_dir, stem + ann_ext)
        img_paths.append(os.path.join(image_dir, f))
        ann_paths.append(ann if os.path.exists(ann) else "")
    return img_paths, ann_paths


class PrefetchDataset:
    """Iterator of ``{"image", "groundtruth_boxes"}`` dicts decoded by C++
    worker threads with a bounded prefetch queue.

    Drop-in data source for ``waldboost_tpu.train`` — the ragged host side of
    the input pipeline runs concurrently with device compute.
    """

    def __init__(self, img_paths: Sequence[str],
                 ann_paths: Optional[Sequence[str]] = None,
                 n_threads: int = 4, queue_cap: int = 16, loop: bool = False,
                 max_pixels: int = 1 << 24):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (g++ build failed)")
        self._lib = lib
        self._img_paths = [p.encode() for p in img_paths]
        self._ann_paths = None
        if ann_paths is not None:
            self._ann_paths = [p.encode() if p else b"" for p in ann_paths]
        n = len(self._img_paths)
        ImgArr = ctypes.c_char_p * n
        img_arr = ImgArr(*self._img_paths)
        ann_arr = None
        if self._ann_paths is not None:
            ann_arr = ImgArr(*self._ann_paths)
        self._handle = lib.wb_prefetcher_create(
            img_arr, ann_arr, n, n_threads, queue_cap, 1 if loop else 0)
        self._max_pixels = max_pixels
        self._img_buf = np.zeros(max_pixels, np.uint8)
        self._rects_buf = np.zeros((4096, 4), np.float32)
        self._ignore_buf = np.zeros(4096, np.int32)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._handle is None:
            raise StopIteration
        h = ctypes.c_int()
        w = ctypes.c_int()
        n_rects = ctypes.c_int()
        index = ctypes.c_int64()
        rc = self._lib.wb_prefetcher_next(
            self._handle,
            self._img_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._max_pixels, ctypes.byref(h), ctypes.byref(w),
            self._rects_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            4096, ctypes.byref(n_rects),
            self._ignore_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.byref(index))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"decode failed for item {index.value} (code {rc})")
        image = self._img_buf[:h.value * w.value].reshape(
            h.value, w.value).copy()
        nb = n_rects.value
        gt = Boxes(self._rects_buf[:nb].copy(),
                   ignore=self._ignore_buf[:nb].copy())
        return dict(image=image, groundtruth_boxes=gt, index=index.value)

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.wb_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def bbgt_training_stream(image_dir: str, annotation_dir: str,
                         image_ext: str = ".pgm", ann_ext: str = ".txt",
                         loop: bool = True, prefer_native: bool = True,
                         n_threads: int = 4, queue_cap: int = 16):
    """Training-record stream over a bbGt-style dataset directory pair.

    Yields ``{"image", "groundtruth_boxes"}`` dicts — the record shape
    ``waldboost_tpu.train`` consumes (the dataset-dir training entry the
    reference drives from /root/reference/scripts/training.py:27-60).
    With the native loader built, records come from the C++ threaded
    :class:`PrefetchDataset`; otherwise a pure-Python generator decodes
    through the PIL/parser fallbacks.  ``loop=True`` cycles the dataset
    forever (training pulls records until pool quotas are met each stage).
    """
    img_paths, ann_paths = bbgt_dataset_paths(image_dir, annotation_dir,
                                              image_ext, ann_ext)
    if not img_paths:
        raise FileNotFoundError(
            f"no '{image_ext}' images found in {image_dir!r}")
    if prefer_native and native_available():
        return PrefetchDataset(img_paths, ann_paths, n_threads=n_threads,
                               queue_cap=queue_cap, loop=loop)

    def _gen():
        while True:
            for i, (ip, ap) in enumerate(zip(img_paths, ann_paths)):
                image = load_pnm_gray(ip)
                if ap:
                    gt = read_bbgt_native(ap)
                else:
                    gt = Boxes(np.zeros((0, 4), np.float32),
                               ignore=np.zeros(0, np.int32))
                yield dict(image=image, groundtruth_boxes=gt, index=i)
            if not loop:
                return

    return _gen()
