"""MNIST iterator.

Copied from ``deeplearning4j_tpu/datasets/mnist.py`` (numpy only): the
input of the LeNet-MNIST baseline. If IDX files exist under ``data_dir``
(or ``$MNIST_DIR``: train-images-idx3-ubyte etc., optionally .gz) they
are read as DL4J's MnistDataSetIterator reads them; otherwise a
deterministic procedural digit set is synthesised (7-segment glyphs on
28x28 with random translation, brightness jitter and pixel noise),
bit-equal to the JAX package's for the same seed. Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

# 7-segment encodings per digit: segments (top, top-left, top-right, middle,
# bottom-left, bottom-right, bottom)
_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1),
    1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1),
    3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0),
    5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1),
    7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1),
    9: (1, 1, 1, 1, 0, 1, 1),
}


def _render_digit(d, rng):
    """Render one 28x28 glyph with jitter."""
    img = np.zeros((28, 28), np.float32)
    seg = _SEGMENTS[d]
    # base glyph box ~ rows 4..24, cols 8..20, thickness 2
    t = 2
    x0, x1 = 8, 19
    y0, ym, y1 = 4, 13, 23
    bars = [
        (seg[0], (y0, y0 + t), (x0, x1 + 1)),          # top
        (seg[1], (y0, ym + 1), (x0, x0 + t)),          # top-left
        (seg[2], (y0, ym + 1), (x1 - t + 1, x1 + 1)),  # top-right
        (seg[3], (ym, ym + t), (x0, x1 + 1)),          # middle
        (seg[4], (ym, y1 + 1), (x0, x0 + t)),          # bottom-left
        (seg[5], (ym, y1 + 1), (x1 - t + 1, x1 + 1)),  # bottom-right
        (seg[6], (y1 - t + 1, y1 + 1), (x0, x1 + 1)),  # bottom
    ]
    for on, (r0, r1), (c0, c1) in bars:
        if on:
            img[r0:r1, c0:c1] = 1.0
    # jitter: translate +-3 px, brightness scale, additive noise
    dy, dx = rng.integers(-3, 4, size=2)
    img = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    img *= rng.uniform(0.7, 1.0)
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def synthesize_mnist(n, seed=123):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = np.stack([_render_digit(int(d), rng) for d in labels])
    return images.reshape(n, 784).astype(np.float32), labels.astype(np.int64)


def _read_idx(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(data_dir, stem):
    for name in (stem, stem + ".gz"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


class MnistDataSetIterator(DataSetIterator):
    def __init__(self, batch_size=128, train=True, seed=123, data_dir=None,
                 num_examples=None, binarize=False):
        super().__init__(batch_size)
        data_dir = data_dir or os.environ.get("MNIST_DIR")
        imgs = lbls = None
        if data_dir:
            stem = ("train" if train else "t10k")
            ip = _find_idx(data_dir, f"{stem}-images-idx3-ubyte")
            lp = _find_idx(data_dir, f"{stem}-labels-idx1-ubyte")
            if ip and lp:
                imgs = (_read_idx(ip).reshape(-1, 784).astype(np.float32)
                        / 255.0)
                lbls = _read_idx(lp).astype(np.int64)
        if imgs is None:
            n = num_examples or (10000 if train else 2000)
            imgs, lbls = synthesize_mnist(n, seed if train else seed + 1)
            self.synthetic = True
        else:
            self.synthetic = False
        if num_examples:
            imgs, lbls = imgs[:num_examples], lbls[:num_examples]
        if binarize:
            imgs = (imgs > 0.5).astype(np.float32)
        self._images = imgs
        self._onehot = np.eye(10, dtype=np.float32)[lbls]
        self._pos = 0

    def totalOutcomes(self):
        return 10

    def inputColumns(self):
        return 784

    def totalExamples(self):
        return self._images.shape[0]

    def reset(self):
        self._pos = 0
        self._peek = None

    def _next_batch(self):
        if self._pos >= self._images.shape[0]:
            return None
        i, j = self._pos, self._pos + self._batch
        self._pos = j
        return DataSet(self._images[i:j], self._onehot[i:j])
