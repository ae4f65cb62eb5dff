"""Vision datasets.

Port of ``mxnet_tpu/gluon/data/vision/datasets.py``.  ``MNIST``,
``FashionMNIST``, ``CIFAR10`` and ``CIFAR100`` read the standard IDX and
binary files under ``root``, or draw the reference's deterministic
synthetic data (``synthetic=True``, or no files): the same images and
labels in both packages.  The images are held on the host (CPU
NDArrays), so DataLoader workers can read them without CUDA; the
reference keeps them on its default context.  ``ImageRecordDataset``,
``ImageFolderDataset`` and ``ImageListDataset`` decode each item on the
host (``image.imdecode``/``imread`` with a CPU context), so a forked
DataLoader worker never touches CUDA.
"""
from __future__ import annotations

import gzip
import os
import struct
import numpy as _np

from ....base import MXNetError
from .... import ndarray as nd
from ....context import cpu
from ..dataset import _DownloadedDataset, Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageListDataset",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticMNIST",
           "SyntheticInstanceSegDataset"]


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = _np.frombuffer(f.read(), dtype=_np.uint8)
        return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        return _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)


def _synthetic_classification(n, shape, num_classes, seed):
    """Deterministic learnable synthetic data: class-dependent means."""
    rng = _np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=(n,)).astype(_np.int32)
    protos = rng.uniform(0, 255, size=(num_classes,) + shape)
    data = protos[labels] + rng.normal(0, 16, size=(n,) + shape)
    return _np.clip(data, 0, 255).astype(_np.uint8), labels


class MNIST(_DownloadedDataset):
    """MNIST from local IDX files, else synthetic."""

    _files = {True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "mnist"),
                 train=True, transform=None, synthetic=None,
                 synthetic_size=None):
        self._train = train
        self._synthetic = synthetic
        self._synthetic_size = synthetic_size
        super().__init__(root, transform)

    def _get_data(self):
        img_name, lbl_name = self._files[self._train]
        img_path = os.path.join(self._root, img_name)
        lbl_path = os.path.join(self._root, lbl_name)
        use_synth = self._synthetic
        if use_synth is None:
            use_synth = not (os.path.exists(img_path) or
                             os.path.exists(img_path + ".gz"))
        if use_synth:
            n = self._synthetic_size or (6000 if self._train else 1000)
            data, labels = _synthetic_classification(
                n, self._shape, self._classes,
                seed=42 if self._train else 43)
        else:
            if not os.path.exists(img_path) and \
                    os.path.exists(img_path + ".gz"):
                img_path += ".gz"
                lbl_path += ".gz"
            data = _read_idx_images(img_path)
            labels = _read_idx_labels(lbl_path)
            if self._shape[2] == 3 and data.shape[-1] == 1:
                data = _np.repeat(data, 3, axis=3)
        self._data = nd.array(data, dtype="uint8", ctx=cpu())
        self._label = labels

    def __getitem__(self, idx):
        img = self._data[idx]
        label = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None, synthetic=None,
                 synthetic_size=None):
        super().__init__(root, train, transform, synthetic, synthetic_size)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from local binary batches, else synthetic."""

    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None, synthetic=None,
                 synthetic_size=None):
        self._train = train
        self._synthetic = synthetic
        self._synthetic_size = synthetic_size
        super().__init__(root, transform)

    def _file_list(self):
        if self._train:
            return ["data_batch_%d.bin" % i for i in range(1, 6)]
        return ["test_batch.bin"]

    def _get_data(self):
        files = [os.path.join(self._root, f) for f in self._file_list()]
        use_synth = self._synthetic
        if use_synth is None:
            use_synth = not os.path.exists(files[0])
        if use_synth:
            n = self._synthetic_size or (5000 if self._train else 1000)
            data, labels = _synthetic_classification(
                n, self._shape, self._classes,
                seed=44 if self._train else 45)
        else:
            data_list, label_list = [], []
            for path in files:
                with open(path, "rb") as f:
                    raw = _np.frombuffer(f.read(), dtype=_np.uint8)
                raw = raw.reshape(-1, 3073)
                label_list.append(raw[:, 0].astype(_np.int32))
                data_list.append(
                    raw[:, 1:].reshape(-1, 3, 32, 32).transpose(
                        0, 2, 3, 1))
            data = _np.concatenate(data_list)
            labels = _np.concatenate(label_list)
        self._data = nd.array(data, dtype="uint8", ctx=cpu())
        self._label = labels

    def __getitem__(self, idx):
        img = self._data[idx]
        label = int(self._label[idx])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None,
                 synthetic=None, synthetic_size=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform, synthetic, synthetic_size)

    def _file_list(self):
        return ["train.bin"] if self._train else ["test.bin"]


class ImageRecordDataset(Dataset):
    """Dataset over a .rec file of packed images."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._rec = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._rec)

    def __getitem__(self, idx):
        from .... import recordio, image
        record = self._rec[idx]
        header, img = recordio.unpack(record)
        img = image.imdecode(img, self._flag, ctx=cpu())
        label = header.label
        if isinstance(label, _np.ndarray) and label.size == 1:
            label = float(label[0])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """folder/<class>/<img> layout: ``synsets`` and ``items``."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename),
                                       label))

    def __getitem__(self, idx):
        from .... import image
        img = image.imread(self.items[idx][0], self._flag, ctx=cpu())
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


SyntheticMNIST = MNIST  # the name convergence tests use


class ImageListDataset(Dataset):
    """Images enumerated by a ``.lst`` file (the ``im2rec.py`` listing
    format: ``index\tlabel[\tlabel...]\trelpath``)."""

    def __init__(self, root, imglist, flag=1):
        self._root = root
        self._flag = flag
        self._items = []
        if isinstance(imglist, str):
            with open(imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    labels = [float(v) for v in parts[1:-1]]
                    self._items.append(
                        (os.path.join(root, parts[-1]),
                         labels[0] if len(labels) == 1 else labels))
        else:
            for entry in imglist:
                labels = [float(v) for v in entry[1:-1]]
                self._items.append(
                    (os.path.join(root, entry[-1]),
                     labels[0] if len(labels) == 1 else labels))

    def __len__(self):
        return len(self._items)

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self._items[idx]
        return imread(path, flag=self._flag, ctx=cpu()), label


class SyntheticInstanceSegDataset(Dataset):
    """Instance-segmentation data drawn from a seed: random axis-aligned
    rectangles and ellipses rendered as images with per-instance binary
    masks, boxes and class labels (what a Mask R-CNN-style head's
    ``_contrib_mrcnn_mask_target`` needs).

    Each item: ``(image (C, H, W) float32, label dict)`` with
    ``boxes (M, 4)`` corner coords, ``classes (M,)`` int (1 = rect,
    2 = ellipse), ``masks (M, H, W)`` float32 binary; ``M`` instances
    padded to ``max_instances`` with class 0 rows; host NDArrays.
    """

    def __init__(self, num_samples=64, size=64, max_instances=3,
                 seed=0):
        self._n = num_samples
        self._size = size
        self._max = max_instances
        self._seed = seed

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        rng = _np.random.RandomState(self._seed * 100003 + idx)
        S, M = self._size, self._max
        img = rng.uniform(0.0, 0.1, (3, S, S)).astype("float32")
        n_inst = rng.randint(1, M + 1)
        boxes = _np.zeros((M, 4), "float32")
        classes = _np.zeros((M,), "int32")
        masks = _np.zeros((M, S, S), "float32")
        yy, xx = _np.mgrid[0:S, 0:S]
        for i in range(n_inst):
            w = rng.randint(S // 6, S // 2)
            h = rng.randint(S // 6, S // 2)
            x0 = rng.randint(0, S - w)
            y0 = rng.randint(0, S - h)
            cls = rng.randint(1, 3)
            if cls == 1:                       # rectangle
                m = ((yy >= y0) & (yy < y0 + h)
                     & (xx >= x0) & (xx < x0 + w))
            else:                              # ellipse
                # strict < keeps every mask pixel inside the stored
                # [x0, x0+w-1] x [y0, y0+h-1] box (boundary pixels at
                # exactly 1.0 would fall one past it)
                cy, cx = y0 + h / 2.0, x0 + w / 2.0
                m = (((yy - cy) / (h / 2.0)) ** 2
                     + ((xx - cx) / (w / 2.0)) ** 2) < 1.0
            masks[i] = m.astype("float32")
            boxes[i] = (x0, y0, x0 + w - 1, y0 + h - 1)
            classes[i] = cls
            color = rng.uniform(0.4, 1.0, (3, 1))
            img[:, m] = color
        return (nd.array(img, ctx=cpu()),
                {"boxes": nd.array(boxes, ctx=cpu()),
                 "classes": nd.array(classes, ctx=cpu()),
                 "masks": nd.array(masks, ctx=cpu())})
