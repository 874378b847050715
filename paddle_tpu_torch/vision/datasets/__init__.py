"""Vision datasets (mirrors ``paddle_tpu/vision/datasets/__init__.py``):
``MNIST`` and ``FashionMNIST``. Nothing is downloaded. With files the
loader parses the real idx format (gzip or raw; magic 2051 for images
and 2049 for labels, big-endian headers) from ``image_path`` and
``label_path`` or from the standard file names under ``root``. Without
them it raises unless the caller opts into a deterministic synthetic set
with ``synthetic_size=N`` (``io.synthetic_optin``): the reference's
class-dependent blobs from ``np.random.RandomState(42)`` (train) or 43
(test), the same images and labels. A sample is the image scaled to
``[-1, 1]`` as ``[1, 28, 28]`` f32 and its int64 label.

CIFAR-10/100, Flowers and VOC2012 are ROADMAP queue 1 item 9b-2.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset, synthetic_optin as _synthetic_optin

__all__ = ["MNIST", "FashionMNIST"]


def _find_mnist_files(root, mode):
    stem = "train" if mode == "train" else "t10k"
    img = os.path.join(root, f"{stem}-images-idx3-ubyte.gz")
    lbl = os.path.join(root, f"{stem}-labels-idx1-ubyte.gz")
    if os.path.exists(img) and os.path.exists(lbl):
        return img, lbl
    return None, None


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None,
                 synthetic_size=None, root=None):
        self.mode = mode
        self.transform = transform
        if root and not image_path:
            image_path, label_path = _find_mnist_files(root, mode)
        if image_path and os.path.exists(image_path):
            with _open(image_path) as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                if magic != 2051:
                    raise ValueError(
                        f"{image_path}: bad idx3 magic {magic} (want 2051)")
                self.images = np.frombuffer(
                    f.read(n * rows * cols), np.uint8).reshape(n, rows, cols)
            with _open(label_path) as f:
                magic, n2 = struct.unpack(">II", f.read(8))
                if magic != 2049:
                    raise ValueError(
                        f"{label_path}: bad idx1 magic {magic} (want 2049)")
                self.labels = np.frombuffer(f.read(n2), np.uint8)
            if len(self.labels) != len(self.images):
                raise ValueError(
                    f"mnist: {len(self.images)} images vs "
                    f"{len(self.labels)} labels")
        else:
            n = _synthetic_optin("MNIST", synthetic_size,
                                 6000 if mode == "train" else 1000)
            r = np.random.RandomState(42 if mode == "train" else 43)
            self.labels = r.randint(0, 10, n).astype(np.int64)
            # class-dependent blobs so a real model can learn
            self.images = np.zeros((n, 28, 28), np.uint8)
            for i, lbl in enumerate(self.labels):
                img = r.rand(28, 28) * 64
                row, col = divmod(int(lbl), 5)
                img[row * 12 + 2:row * 12 + 12, col * 5 + 1:col * 5 + 5] += 180
                self.images[i] = img.clip(0, 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None] / 127.5 - 1.0
        lbl = np.asarray(self.labels[idx], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, lbl

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass
