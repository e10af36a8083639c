"""Image loading + augmentation pipeline.

Copied from ``deeplearning4j_tpu/datasets/image.py`` (numpy and PIL on
the host; the port keeps its own copy, with the port's native resize).

Reference capability: `datavec-data-image` —
org.datavec.image.recordreader.ImageRecordReader (+
ParentPathLabelGenerator), org.datavec.image.loader.NativeImageLoader
(JavaCPP OpenCV) and org.datavec.image.transform.* augmentations
(SURVEY.md §2.4): the image input path that ResNet-50 trains from.
Decoding is host-side PIL/numpy — ETL stays off the
device; arrays come out NCHW float32, the layout every conv layer here
expects."""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.records import InputSplit, RecordReader


def _require_pil():
    try:
        from PIL import Image  # noqa: F401

        return Image
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "image loading needs Pillow (PIL), which is unavailable") from e


class PathLabelGenerator:
    def getLabelForPath(self, path) -> str:
        raise NotImplementedError


class ParentPathLabelGenerator(PathLabelGenerator):
    """Label = name of the file's parent directory (the reference's
    standard image-folder-tree convention)."""

    def getLabelForPath(self, path):
        return os.path.basename(os.path.dirname(os.path.abspath(path)))


def _bilinear_resize_chw(src_hwc_u8: np.ndarray, oh: int,
                         ow: int) -> np.ndarray:
    """numpy twin of the native resize_hwc_to_chw kernel: half-pixel-center
    classic bilinear (no antialiasing), [H,W,C]u8 -> [C,oh,ow]f32."""
    h, w, _ = src_hwc_u8.shape
    fy = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, None)
    fx = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, None)
    y0 = np.minimum(fy.astype(np.int64), h - 1)
    x0 = np.minimum(fx.astype(np.int64), w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None].astype(np.float32)
    wx = (fx - x0)[None, :, None].astype(np.float32)
    s = src_hwc_u8.astype(np.float32)
    top = s[y0][:, x0] * (1 - wx) + s[y0][:, x1] * wx
    bot = s[y1][:, x0] * (1 - wx) + s[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).transpose(2, 0, 1)


class NativeImageLoader:
    """Decode one image file -> [C,H,W] float32 (reference:
    org.datavec.image.loader.NativeImageLoader, minus OpenCV)."""

    def __init__(self, height, width, channels=3):
        self.height, self.width, self.channels = height, width, channels

    def _decode_hwc(self, path_or_image) -> np.ndarray:
        """Decode + color-convert to [H,W,C] uint8 at SOURCE resolution
        (no resize)."""
        img = path_or_image
        if isinstance(img, np.ndarray):
            if img.dtype != np.uint8:
                raise ValueError(
                    f"asMatrix ndarray input must be uint8 [H,W,C] "
                    f"(got dtype {img.dtype}); normalize AFTER loading "
                    f"with a DataNormalization, not before")
            hwc = img[:, :, None] if img.ndim == 2 else img
        else:
            if not hasattr(img, "convert"):
                Image = _require_pil()
                img = Image.open(path_or_image)
            img = img.convert("L" if self.channels == 1 else "RGB")
            hwc = np.asarray(img, np.uint8)
            if hwc.ndim == 2:
                hwc = hwc[:, :, None]
        if hwc.shape[2] != self.channels:
            if self.channels == 1:
                # luma conversion, same coefficients as PIL convert("L")
                hwc = (hwc[:, :, :3].astype(np.float32)
                       @ np.asarray([0.299, 0.587, 0.114], np.float32))
                hwc = hwc.astype(np.uint8)[:, :, None]
            elif self.channels == 3 and hwc.shape[2] == 1:
                hwc = np.repeat(hwc, 3, axis=2)
            else:
                raise ValueError(
                    f"cannot convert {hwc.shape[2]}-channel image to "
                    f"{self.channels} channels")
        if hwc.shape[0] == 0 or hwc.shape[1] == 0:
            raise ValueError(f"empty image {hwc.shape}")
        return hwc

    def asMatrix(self, path_or_image) -> np.ndarray:
        """Resize semantics are classic half-pixel-center bilinear (OpenCV
        INTER_LINEAR — what the reference's NativeImageLoader does), NOT
        PIL's antialiased downscale. The native kernel and the numpy
        fallback implement the SAME math, so pixel values do not depend
        on whether the g++ toolchain was present. PIL is used only to
        decode files and convert color modes."""
        from deeplearning4j_tpu_torch import native

        hwc = self._decode_hwc(path_or_image)
        if hwc.shape[0] == self.height and hwc.shape[1] == self.width:
            # identity resize: half-pixel-center bilinear at 1:1 scale
            # maps every output pixel exactly onto its source pixel
            # (fy = i, wy = 0), so the interpolation reduces to a cast
            return np.ascontiguousarray(
                hwc.transpose(2, 0, 1)).astype(np.float32)
        if native.available():
            chw = native.resize_hwc_to_chw(hwc, self.height, self.width)
            if chw is not None:
                return chw
        return _bilinear_resize_chw(hwc, self.height, self.width)

    def asBytes(self, path_or_image) -> np.ndarray | None:
        """[C,H,W] uint8 when the decoded image is ALREADY exactly
        height x width (no resample needed), else None. The uint8 form
        is bit-faithful: ``asBytes(p).astype(float32) == asMatrix(p)``
        whenever it is available, which is what lets ETL workers ship
        quarter-size decode output over IPC and defer the float cast to
        the consumer (or the device) without changing a single pixel."""
        hwc = self._decode_hwc(path_or_image)
        if hwc.shape[0] == self.height and hwc.shape[1] == self.width:
            return np.ascontiguousarray(hwc.transpose(2, 0, 1))
        return None


# ---------------------------------------------------------------------------
# augmentation transforms (reference: org.datavec.image.transform)
# ---------------------------------------------------------------------------

class ImageTransform:
    """Transforms operate on [C,H,W] float arrays with an optional rng."""

    def transform(self, arr: np.ndarray, rng=None) -> np.ndarray:
        raise NotImplementedError


class ResizeImageTransform(ImageTransform):
    def __init__(self, newHeight, newWidth):
        self.h, self.w = newHeight, newWidth

    def transform(self, arr, rng=None):
        Image = _require_pil()
        chans = [np.asarray(
            Image.fromarray(c).resize((self.w, self.h),
                                      Image.Resampling.BILINEAR),
            np.float32) for c in arr]
        return np.stack(chans, 0)


class FlipImageTransform(ImageTransform):
    """flipMode: 0 = vertical, 1 = horizontal, -1 = both (OpenCV codes,
    same as the reference); None = random choice per call."""

    def __init__(self, flipMode=1):
        self.mode = flipMode

    def transform(self, arr, rng=None):
        mode = self.mode
        if mode is None:
            mode = (rng or np.random.default_rng()).integers(-1, 2)
        if mode in (0, -1):
            arr = arr[:, ::-1, :]
        if mode in (1, -1):
            arr = arr[:, :, ::-1]
        return np.ascontiguousarray(arr)


class CropImageTransform(ImageTransform):
    """Random crop by up to the given margins (reference semantics)."""

    def __init__(self, cropTop=0, cropLeft=0, cropBottom=0, cropRight=0):
        if cropLeft == 0 and cropBottom == 0 and cropRight == 0 \
                and cropTop > 0:
            # single-arg form crops all sides up to N
            cropLeft = cropBottom = cropRight = cropTop
        self.t, self.l, self.b, self.r = (cropTop, cropLeft, cropBottom,
                                          cropRight)

    def transform(self, arr, rng=None):
        rng = rng or np.random.default_rng()
        _, h, w = arr.shape
        t = int(rng.integers(0, self.t + 1))
        l = int(rng.integers(0, self.l + 1))
        b = int(rng.integers(0, self.b + 1))
        r = int(rng.integers(0, self.r + 1))
        return np.ascontiguousarray(arr[:, t:h - b, :][:, :, l:w - r])


class ScaleImageTransform(ImageTransform):
    def __init__(self, delta):
        self.delta = delta

    def transform(self, arr, rng=None):
        rng = rng or np.random.default_rng()
        s = 1.0 + float(rng.uniform(-self.delta, self.delta))
        Image = _require_pil()
        _, h, w = arr.shape
        nh, nw = max(1, int(h * s)), max(1, int(w * s))
        chans = [np.asarray(
            Image.fromarray(c).resize((nw, nh),
                                      Image.Resampling.BILINEAR),
            np.float32) for c in arr]
        return np.stack(chans, 0)


class PipelineImageTransform(ImageTransform):
    """Sequence of (transform, probability) applied in order (reference:
    PipelineImageTransform; shuffle=False ordering)."""

    def __init__(self, transforms, seed=None):
        # accepts [transform, ...] or [(transform, prob), ...]
        self.steps = [(t, 1.0) if isinstance(t, ImageTransform) else t
                      for t in transforms]
        self.rng = np.random.default_rng(seed)

    def transform(self, arr, rng=None):
        rng = rng or self.rng
        for t, p in self.steps:
            if p >= 1.0 or rng.random() < p:
                arr = t.transform(arr, rng)
        return arr


# ---------------------------------------------------------------------------
# ImageRecordReader
# ---------------------------------------------------------------------------

class ImageRecordReader(RecordReader):
    """Walk an image-folder tree -> records [image [C,H,W] f32, labelIdx]
    (reference: org.datavec.image.recordreader.ImageRecordReader).

    Labels are the sorted unique values from the label generator, fixed
    at initialize() so the class-index mapping is stable across epochs."""

    def __init__(self, height, width, channels=3,
                 labelGenerator: PathLabelGenerator | None = None,
                 imageTransform: ImageTransform | None = None, seed=None):
        self.loader = NativeImageLoader(height, width, channels)
        self.labelGen = labelGenerator
        self.imageTransform = imageTransform
        self.rng = np.random.default_rng(seed)
        self._files = []
        self._labels = []
        self._pos = 0

    def initialize(self, split: InputSplit):
        self._files = [f for f in split.locations()
                       if f.lower().endswith((".png", ".jpg", ".jpeg",
                                              ".bmp", ".gif"))]
        if self.labelGen is not None:
            self._labels = sorted(
                {self.labelGen.getLabelForPath(f) for f in self._files})
        self._pos = 0

    def getLabels(self):
        return list(self._labels)

    def numLabels(self):
        return len(self._labels)

    def hasNext(self):
        return self._pos < len(self._files)

    def next(self):
        if not self.hasNext():
            raise StopIteration
        path = self._files[self._pos]
        self._pos += 1
        arr = self.loader.asMatrix(path)
        if self.imageTransform is not None:
            arr = self.imageTransform.transform(arr, self.rng)
        rec = [arr]
        if self.labelGen is not None:
            rec.append(self._labels.index(
                self.labelGen.getLabelForPath(path)))
        return rec

    def reset(self):
        self._pos = 0
