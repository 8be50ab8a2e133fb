"""The datasets of the entry points, each dataset branch written once.

The JAX package builds its arrays inline in three scripts, one branch per
`data.name` in each: `scripts/train.py::build_dataset` (train and test
pairs), `scripts/test.py:108-180` (the OOD test set) and
`scripts/anomaly_model_train.py:69-118` (a PatchCore bank's normal
images).  The port's `scripts.train`, `scripts.test` and `ood.bank` share
these three functions, which reproduce those branches' seeds, file orders
and cuts exactly:

  * `mri` and `mvtec*` shuffle the sorted glob with the legacy generator
    seeded 42 (the JAX scripts' `np.random.seed(42)` then
    `np.random.shuffle`; `np.random.RandomState(42)` gives the same order
    without touching the global state), the bank's `mvtec` branch excepted,
    which keeps the sorted order;
  * `mnist` falls back to synthetic digits, printing the JAX scripts' line,
    where its idx files are missing (data, not a device fallback);
  * names are tested as the JAX scripts test them: `"mvtec" in name`,
    `name.startswith("synthetic_texture")`, and in the bank only the exact
    name `synthetic_texture`.

Every array is NHWC float32 (MNIST labels aside).  `add_data_args` and
`with_data_paths` give each command line the dataset locations, since a
configuration's paths name files the repository does not hold.  The
MNIST reader is numpy only; BraTS and MVTec decode their PNGs with PIL,
imported where a file is read.
"""

from __future__ import annotations

import dataclasses
import glob
from typing import Optional, Tuple

import numpy as np

from localdiffusion_tpu_torch.config import Config
from localdiffusion_tpu_torch.data.brats import BRATSPngDataset
from localdiffusion_tpu_torch.data.mnist import MNISTDataset, load_mnist_arrays
from localdiffusion_tpu_torch.data.mvtec import MvtecDatasetSR, salt_and_pepper, sr_degrade
from localdiffusion_tpu_torch.data.synthetic import (
    synthetic_brain_translation,
    synthetic_digits,
    synthetic_textures,
)

Pairs = Tuple[np.ndarray, np.ndarray]


def _shuffled_glob(pattern: str) -> np.ndarray:
    """The sorted glob in the JAX scripts' seeded shuffle (seed 42)."""
    files = np.array(sorted(glob.glob(pattern)))
    np.random.RandomState(42).shuffle(files)
    return files


def _brain_norm(cfg: Config) -> dict:
    d = cfg.data
    return dict(mean_t1=d.mean_t1, std_t1=d.std_t1, mean_flair=d.mean_flair,
                std_flair=d.std_flair, translate_zero=d.translate_zero)


def train_arrays(cfg: Config) -> Tuple[Pairs, Pairs]:
    """((hr, lr) train, (hr, lr) test) of `cfg.data.name`, as the JAX
    `scripts/train.py::build_dataset` makes them."""
    name = cfg.data.name
    size = cfg.diffusion.image_size
    if name == "mnist":
        try:
            imgs, labels = load_mnist_arrays(cfg.data.mnist_path, cfg.data.mnist_labels_path)
        except (FileNotFoundError, OSError):
            print("MNIST files not found — using synthetic digits")
            imgs, labels = synthetic_digits(2048, size=size, seed=42)
        # the reference's 70% train split over digit-8 images (ddpm.py:1330-1359)
        split = int(0.7 * len(imgs))
        train = MNISTDataset(imgs[:split], labels[:split], num=[8])
        test = MNISTDataset(imgs[split:], labels[split:], num=[8], max_file=100)
        return train.as_arrays()[:2], test.as_arrays()[:2]
    if name == "synthetic_brain":
        hr, lr, _ = synthetic_brain_translation(256, size, tumor=False, seed=42,
                                                **_brain_norm(cfg))
        hr_te, lr_te, _ = synthetic_brain_translation(32, size, tumor=False, seed=7,
                                                      **_brain_norm(cfg))
        return (hr, lr), (hr_te, lr_te)
    if name.startswith("synthetic_texture"):
        denoise = name.endswith("denoise")  # salt-and-pepper conditioning (data.py:248-277)

        def degrade(im2, i):
            if denoise:
                return salt_and_pepper(im2 / 2.0, seed=i) * 2.0
            return sr_degrade(im2)

        imgs, _ = synthetic_textures(192, size=size, seed=42)
        hr = imgs * 2.0  # [0, 2], as the MVTec readers (data.py:294-297)
        lr = np.stack([degrade(im, i) for i, im in enumerate(hr)])
        imgs_te, _ = synthetic_textures(24, size=size, seed=7)
        hr_te = imgs_te * 2.0
        lr_te = np.stack([degrade(im, 1000 + i) for i, im in enumerate(hr_te)])
        return (hr, lr), (hr_te, lr_te)
    if name == "synthetic":
        imgs, labels = synthetic_digits(512, size=size, seed=42, digit=8)
        hr, lr, _ = MNISTDataset(imgs, labels, lr_mode="full").as_arrays()
        return (hr[:400], lr[:400]), (hr[400:], lr[400:])
    if name == "mri":
        files = _shuffled_glob(cfg.data.mri_files)
        split = int(0.5 * len(files))
        tr = BRATSPngDataset(cfg.data, files[:split], train=True, crop=size)
        te = BRATSPngDataset(cfg.data, files[split:], train=False, tumor=False, crop=size)
        hr, lr, _ = tr.as_arrays()
        hr_te, lr_te, _ = te.as_arrays()
        return (hr, lr), (hr_te, lr_te)
    if "mvtec" in name:
        files = _shuffled_glob(cfg.data.mvtec_path)
        tr = MvtecDatasetSR(files, train=True, size=size)
        te = MvtecDatasetSR(files, train=False, size=size, max_num=24)
        hr, lr, _, _ = tr.as_arrays()
        hr_te, lr_te, _, _ = te.as_arrays()
        return (hr, lr), (hr_te, lr_te)
    raise NotImplementedError(f"unknown dataset {name}")


def test_arrays(cfg: Config, max_images: int) -> Tuple[np.ndarray, np.ndarray,
                                                         Optional[np.ndarray]]:
    """(hr, lr, seg or None) of the OOD test set of `cfg.data.name`, as the
    JAX `scripts/test.py:108-180` makes it: seg holds the ground-truth
    masks where the dataset has them (synthetic brains and textures, BraTS)."""
    name = cfg.data.name
    size = cfg.diffusion.image_size
    if name == "synthetic_brain":
        return synthetic_brain_translation(min(max_images, 32), size, tumor=True, seed=0,
                                           **_brain_norm(cfg))
    if name.startswith("synthetic_texture"):
        imgs, dmasks = synthetic_textures(min(max_images, 16), size=size, seed=0, defect=True)
        hr = imgs * 2.0
        if name.endswith("denoise"):
            lr = np.stack([salt_and_pepper(im / 2.0, seed=i) * 2.0 for i, im in enumerate(hr)])
        else:
            lr = np.stack([sr_degrade(im) for im in hr])
        return hr, lr, dmasks  # the defect masks serve as ground-truth masks
    if name == "mnist":
        try:
            imgs, labels = load_mnist_arrays(
                cfg.data.mnist_path.replace("train-", "t10k-"),
                cfg.data.mnist_labels_path.replace("train-", "t10k-"))
        except (FileNotFoundError, OSError):
            print("MNIST test files not found — synthetic")
            imgs, labels = synthetic_digits(256, size=size, seed=0)
        ds = MNISTDataset(imgs, labels, num=[cfg.data.anomaly_name], max_file=max_images)
        hr, lr, _ = ds.as_arrays()
        return hr, lr, None
    if name == "mri":
        files = _shuffled_glob(cfg.data.mri_files)
        split = int(0.5 * len(files))  # the OOD test half (reference test.py:74-80)
        ds = BRATSPngDataset(cfg.data, files[split:], train=False, tumor=True, crop=size,
                             max_test=max_images, mode="t1")
        return ds.as_arrays()
    if "mvtec" in name:
        files = _shuffled_glob(cfg.data.mvtec_path)
        ds = MvtecDatasetSR(files, train=False, mode=[str(cfg.data.anomaly_name)], size=size,
                            max_num=max_images)
        hr, lr, _, _ = ds.as_arrays()
        return hr, lr, None
    raise NotImplementedError(f"unknown dataset {name}")


def bank_images(cfg: Config, n: int) -> np.ndarray:
    """The normal conditioning images [n', H, W, C] a PatchCore bank is
    built from, as the JAX `scripts/anomaly_model_train.py:69-118` takes
    them (n its `--max-images`): MNIST's digit 8, synthetic textures (the
    exact name `synthetic_texture`), normal synthetic brains, the BraTS
    training slices, the MVTec `good` images."""
    name = cfg.data.name
    size = cfg.diffusion.image_size
    if name == "mnist":
        try:
            imgs, labels = load_mnist_arrays(cfg.data.mnist_path, cfg.data.mnist_labels_path)
        except (FileNotFoundError, OSError):
            imgs, labels = synthetic_digits(512, seed=42)
        # the normal class: digit 8 (anomaly_model_train.py:262-280)
        return MNISTDataset(imgs, labels, num=[8], max_file=n).as_arrays()[1]
    if name == "synthetic_texture":
        imgs, _ = synthetic_textures(n, size=size, seed=42)
        return np.stack([sr_degrade(im * 2.0) for im in imgs])
    if name == "synthetic_brain":
        d = cfg.data
        return synthetic_brain_translation(
            n, size, tumor=False, seed=42, mean_t1=d.mean_t1, std_t1=d.std_t1,
            mean_flair=d.mean_flair, std_flair=d.std_flair)[1]
    if name == "mri":
        files = _shuffled_glob(cfg.data.mri_files)
        return BRATSPngDataset(cfg.data, files[:n], train=True, crop=size).as_arrays()[1]
    if "mvtec" in name:
        files = np.array(sorted(glob.glob(cfg.data.mvtec_path)))
        return MvtecDatasetSR(files, train=True, size=size, max_num=n).as_arrays()[1]
    raise NotImplementedError(f"unknown dataset {name}")


DATA_PATHS = ("mnist_path", "mnist_labels_path", "mri_files", "mvtec_path")


def add_data_args(ap) -> None:
    """The dataset locations as options of a command line (`--mnist-path`
    and so on), each overriding the configuration's `data` field."""
    help_ = {"mnist_path": "the MNIST images' idx file (.gz read too); the test set's is "
                           "this path with 'train-' replaced by 't10k-'",
             "mnist_labels_path": "the MNIST labels' idx file",
             "mri_files": "a glob of the BraTS *_flair.png files",
             "mvtec_path": "a glob of the MVTec image files"}
    for field in DATA_PATHS:
        ap.add_argument("--" + field.replace("_", "-"), default=None, help=help_[field])


def with_data_paths(cfg: Config, args) -> Config:
    """`cfg` with the locations given on the command line (`add_data_args`)."""
    over = {f: getattr(args, f) for f in DATA_PATHS if getattr(args, f, None) is not None}
    return cfg.replace(data=dataclasses.replace(cfg.data, **over)) if over else cfg
