"""Vision datasets — counterpart of
``paddle_tpu/vision/datasets/__init__.py``: MNIST (and FashionMNIST)
from local idx-gzip files, CIFAR-10/100 from the local python-version
tarball, ``DatasetFolder``/``ImageFolder`` over ``.npy`` files (or a
caller's loader), and ``FakeData``, a seeded synthetic stream. Nothing
downloads: a missing file raises ``RuntimeError``, and
``download=True`` changes nothing. They are the port's ``io.Dataset``s
and yield numpy arrays."""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io import Dataset


class FakeData(Dataset):
    """Synthetic dataset: deterministic random images + labels (benchmark
    input pipeline; not in the reference, needed for offline parity tests)."""

    def __init__(self, size=1000, image_shape=(224, 224, 3), num_classes=1000,
                 transform=None, seed=0):
        self.size = size
        # images are generated HWC (the layout every transform expects)
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.randint(0, 256, size=self.image_shape, dtype=np.uint8)
        label = rng.randint(0, self.num_classes)
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32) / 255.0
        return img, np.int64(label)


class MNIST(Dataset):
    """MNIST from local idx-gzip files (reference: datasets/mnist.py:§0)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if image_path is None or label_path is None or \
                not os.path.exists(image_path) or not os.path.exists(label_path):
            raise RuntimeError(
                "offline build: provide local image_path/label_path "
                "(download is unavailable)")
        self.mode = mode
        self.transform = transform
        self.images, self.labels = self._load(image_path, label_path)

    @staticmethod
    def _load(image_path, label_path):
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            assert magic == 2051, f"bad MNIST image magic {magic}"
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            magic, n2 = struct.unpack(">II", f.read(8))
            assert magic == 2049, f"bad MNIST label magic {magic}"
            labels = np.frombuffer(f.read(), dtype=np.uint8)
        assert n == n2
        return images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx][:, :, None]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])


FashionMNIST = MNIST  # same file format; caller points at the FashionMNIST files


class Cifar10(Dataset):
    """CIFAR-10/100 from the local python-version tarball
    (reference: datasets/cifar.py:§0)."""

    _n_classes = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None or not os.path.exists(data_file):
            raise RuntimeError(
                "offline build: provide local data_file (download is "
                "unavailable)")
        self.mode = mode
        self.transform = transform
        self.data, self.labels = self._load(data_file, mode)

    def _load(self, data_file, mode):
        datas, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            names = [m for m in tf.getmembers()
                     if (("data_batch" in m.name or "train" in m.name)
                         if mode == "train"
                         else ("test" in m.name))]
            for m in sorted(names, key=lambda m: m.name):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                if b"data" not in d:
                    continue
                datas.append(np.asarray(d[b"data"]))
                key = b"labels" if b"labels" in d else b"fine_labels"
                labels.extend(d[key])
        data = np.concatenate(datas).reshape(-1, 3, 32, 32)
        return data, np.asarray(labels, dtype=np.int64)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img = self.data[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar100(Cifar10):
    _n_classes = 100


_DEFAULT_EXTENSIONS = (".npy",)


def _default_loader(path):
    return np.load(path)


def _iter_valid_files(dirpath, fnames, extensions, is_valid_file):
    for fname in sorted(fnames):
        path = os.path.join(dirpath, fname)
        ok = (is_valid_file(path) if is_valid_file is not None
              else fname.lower().endswith(extensions))
        if ok:
            yield path


class DatasetFolder(Dataset):
    """class-per-subdir image folder (reference: datasets/folder.py:§0).
    ``loader`` defaults to raw-numpy .npy loading; image decoding is
    caller-provided (no PIL/cv2 dependency in this build)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        extensions = extensions or _DEFAULT_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for path in _iter_valid_files(cdir, os.listdir(cdir), extensions,
                                          is_valid_file):
                self.samples.append((path, self.class_to_idx[c]))
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)


class ImageFolder(DatasetFolder):
    """Flat / recursive folder of images without labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        extensions = extensions or _DEFAULT_EXTENSIONS
        self.samples = []
        for dirpath, _, fnames in sorted(os.walk(root)):
            self.samples.extend(
                _iter_valid_files(dirpath, fnames, extensions, is_valid_file))
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return (img,)
