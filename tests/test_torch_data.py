"""The port's data readers and dataset functions against the JAX package's.

Each reader copy (`data/mnist.py`, `mvtec.py`, `brats.py`, `mha.py`,
`folder.py`) reads the fixtures the JAX tests build in `tmp_path` (MNIST idx
files raw and gzipped, BraTS PNG cases, volumes, MetaImage files of every
element type, compressed, external and big-endian, the MVTec tree, a folder
of images), rebuilt here, and returns the JAX reader's arrays bit for bit.
Then `data.datasets`' three functions, for every dataset name, against the
JAX scripts: `train_arrays` against `scripts/train.py::build_dataset`
itself, `test_arrays` and `bank_images` against the inline branches of
`scripts/test.py` and `scripts/anomaly_model_train.py`, rebuilt from the
JAX data functions (the lines cited at each).  Last, the entry points'
dataset plumbing on the CPU at a narrow width: the bank CLI on the MNIST
idx files, its raise for `synthetic_texture_denoise`, and the train and
test CLIs on the MNIST and texture configurations.
"""

import dataclasses
import glob
import gzip
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import localdiffusion_tpu.config as jcfg
import localdiffusion_tpu.data as J
from localdiffusion_tpu.data import brats as j_brats
from localdiffusion_tpu.data import folder as j_folder
from localdiffusion_tpu.data import mha as j_mha
from localdiffusion_tpu.data import mnist as j_mnist
from localdiffusion_tpu.data import mvtec as j_mvtec
from localdiffusion_tpu.data.synthetic import synthetic_textures as j_textures
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch import data as T
from localdiffusion_tpu_torch.data import brats as t_brats
from localdiffusion_tpu_torch.data import datasets as D
from localdiffusion_tpu_torch.data import folder as t_folder
from localdiffusion_tpu_torch.data import mha as t_mha
from localdiffusion_tpu_torch.data import mnist as t_mnist
from localdiffusion_tpu_torch.data import mvtec as t_mvtec
from localdiffusion_tpu_torch.ood import bank as bank_cli
from localdiffusion_tpu_torch.scripts import test as test_cli
from localdiffusion_tpu_torch.scripts import train as train_cli
from test_torch_support import jax_config, small_model_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts.train import build_dataset as jax_build_dataset  # noqa: E402

eq = np.testing.assert_array_equal


def assert_same(got, want):
    """Nested tuples/lists of arrays (or scalars, strings) equal to the bit."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        eq(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# fixtures: the JAX tests' files, rebuilt
# ---------------------------------------------------------------------------

IDX_CODES = {np.dtype(np.uint8): 0x08, np.dtype(np.int8): 0x09, np.dtype(np.int16): 0x0B,
             np.dtype(np.int32): 0x0C, np.dtype(np.float32): 0x0D, np.dtype(np.float64): 0x0E}


def write_idx(path, arr, gz=False):
    """An IDX file (big-endian payload) of `arr`, gzipped when `gz`."""
    arr = np.asarray(arr)
    head = struct.pack(">BBBB", 0, 0, IDX_CODES[arr.dtype], arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)
    return str(path)


def write_mnist(root, n=600, seed=3):
    """Seeded synthetic digits as MNIST idx files under `root`: the images
    raw, the labels gzipped (`<name>.gz`, found by `read_idx` from the bare
    name), train and t10k both.  Returns (images path, labels path) of the
    train set, the arrays written by name."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    written = {}
    for i, split in enumerate(("train", "t10k")):
        imgs, labels = J.synthetic_digits(n, seed=seed + i)
        write_idx(os.path.join(root, f"{split}-images-idx3-ubyte"), imgs)
        write_idx(os.path.join(root, f"{split}-labels-idx1-ubyte.gz"), labels.astype(np.uint8),
                  gz=True)
        written[split] = (imgs, labels.astype(np.uint8))
    return (os.path.join(root, "train-images-idx3-ubyte"),
            os.path.join(root, "train-labels-idx1-ubyte"), written)


def brats_cases(root, n=6, size=40, seed=0):
    """BraTS PNG triplets `case{i}_{t1,flair}.png` + `case{i}_seg.npy`:
    odd cases carry a tumour past 1% of 256², one case lacks its t1 (the
    readers skip it).  Returns the flair paths, sorted."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(str(root), exist_ok=True)
    flairs = []
    for i in range(n):
        stem = os.path.join(str(root), f"case{i}")
        t1 = rng.uniform(0, 800, (size, size)).astype(np.uint16)
        flair = rng.uniform(0, 600, (size, size)).astype(np.uint16)
        seg = np.zeros((size, size), np.uint8)
        if i % 2:
            seg[4:size - 4, 4:size - 4] = 1 + i % 3
        if i != 4:
            Image.fromarray(t1).save(stem + "_t1.png")
        Image.fromarray(flair).save(stem + "_flair.png")
        np.save(stem + "_seg.npy", seg)
        flairs.append(stem + "_flair.png")
    return sorted(flairs)


def mvtec_tree(root, category="grid", n_good=6, n_defect=4, size=32):
    """<root>/<category>/train/good/*.png + test/{broken,good}/*.png, as
    `tests/test_mvtec_tree.py::_make_tree` builds it; returns the glob."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for (split, defect), n in {("train", "good"): n_good, ("test", "broken"): n_defect,
                               ("test", "good"): 2}.items():
        d = os.path.join(str(root), category, split, defect)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = rng.uniform(0, 255, (size, size, 3)).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:03d}.png"))
    return os.path.join(str(root), category, "*", "*", "*.png")


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(IDX_CODES, key=str), ids=str)
@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_read_idx_matches_jax(tmp_path, dtype, gz):
    arr = (np.random.default_rng(1).uniform(-50, 200, (5, 4, 3))).astype(dtype)
    name = str(tmp_path / "x-idx3-ubyte")
    write_idx(name + (".gz" if gz else ""), arr, gz=gz)
    for path in {name + (".gz" if gz else ""), name}:  # the bare name finds the .gz
        got, want = t_mnist.read_idx(path), j_mnist.read_idx(path)
        assert_same(got, want)
        eq(got, arr)


def test_read_idx_refuses_what_jax_refuses(tmp_path):
    p = tmp_path / "bad"
    p.write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x01\x07")
    for mod in (t_mnist, j_mnist):
        with pytest.raises(ValueError, match="not an IDX file"):
            mod.read_idx(str(p))
        with pytest.raises(FileNotFoundError):
            mod.read_idx(str(tmp_path / "missing"))


@pytest.mark.parametrize("mode", ["h_only", "full"])
def test_degrade_and_resize_match_jax(mode):
    img = np.random.default_rng(0).uniform(0, 255, (28, 28)).astype(np.float32)
    assert_same(t_mnist.degrade(img, mode), j_mnist.degrade(img, mode))
    for size in ((28, 28), (13, 31), (56, 40)):
        assert_same(t_mnist._bilinear_resize(img, size), j_mnist._bilinear_resize(img, size))
    with pytest.raises(ValueError):
        t_mnist.degrade(img, "w_only")


@pytest.mark.parametrize("num,max_file,lr_mode", [
    (tuple(range(10)), None, "h_only"), ([8], 7, "h_only"), (3, None, "full"), ([1, 7], 4, "full"),
])
def test_mnist_dataset_matches_jax(num, max_file, lr_mode):
    imgs, labels = J.synthetic_digits(120, seed=5)
    got = T.MNISTDataset(imgs, labels, num=num, max_file=max_file, lr_mode=lr_mode)
    want = J.MNISTDataset(imgs, labels, num=num, max_file=max_file, lr_mode=lr_mode)
    assert len(got) == len(want) > 0
    assert_same(got.labels, want.labels)
    assert_same(got.as_arrays(), want.as_arrays())
    assert_same(got[0], want[0])


def test_load_mnist_arrays_reads_what_was_written(tmp_path):
    images, labels, written = write_mnist(tmp_path, n=40)
    got = T.load_mnist_arrays(images, labels)
    assert_same(got, J.load_mnist_arrays(images, labels))
    assert_same(got, written["train"])


@pytest.mark.parametrize("size", [(4, 4), (8, 8), (6, 3), (5, 9)])
def test_center_crop_matches_jax(size):
    img = np.arange(42, dtype=np.float32).reshape(6, 7)
    assert_same(t_brats._center_crop_np(img, size), j_brats._center_crop_np(img, size))
    assert_same(t_brats._center_crop_np(img[..., None], size),
                j_brats._center_crop_np(img[..., None], size))


BRATS_SETS = [dict(train=True), dict(train=False, tumor=True),
              dict(train=False, tumor=True, max_test=2, mode="t1"),
              dict(train=False, tumor=False, max_test=1)]


@pytest.mark.parametrize("kw", BRATS_SETS, ids=["train", "tumor", "tumor-t1-cap", "normal-cap"])
@pytest.mark.parametrize("translate_zero", [True, False])
def test_brats_png_dataset_matches_jax(tmp_path, kw, translate_zero):
    flairs = brats_cases(tmp_path)
    d = dict(name="mri", translate_zero=translate_zero, mean_t1=300.0, std_t1=350.0)
    got = T.BRATSPngDataset(tcfg.DataConfig(**d), flairs, crop=32, **kw)
    want = J.BRATSPngDataset(jcfg.DataConfig(**d), flairs, crop=32, **kw)
    assert len(got) == len(want) > 0
    assert [i[:2] for i in got.items] == [i[:2] for i in want.items]
    assert_same(got.as_arrays(), want.as_arrays())
    seg_got, seg_want = T.BRATSSegDataset(got), J.BRATSSegDataset(want)
    assert_same(seg_got[0], seg_want[0])


@pytest.mark.parametrize("slice_filter,cap,total", [
    ("none", 2, None), ("healthy", 2, None), ("tumor_capped", 2, None),
    ("healthy_capped", 3, None), ("tumor_capped", 1, 3), ("healthy_capped", 2, 5),
])
def test_brats_volume_dataset_matches_jax(slice_filter, cap, total):
    rng = np.random.RandomState(0)
    vols = [[rng.rand(130, 20, 20).astype(np.float32) * 900 for _ in range(3)] for _ in range(2)]
    segs = [np.zeros((130, 20, 20), np.float32) for _ in range(3)]
    for v, s in enumerate(segs):
        for k in (60, 65, 75 + 5 * v):
            s[k, 4:8, 4:8] = 1.0
    d = dict(name="brats", mean_t1=100.0, std_t1=300.0, mean_flair=80.0, std_flair=250.0)
    kw = dict(crop=16, slice_filter=slice_filter, per_volume_cap=cap, total_cap=total)
    got = T.BRATSVolumeDataset(tcfg.DataConfig(**d), vols[0], vols[1], segs, **kw)
    want = J.BRATSVolumeDataset(jcfg.DataConfig(**d), vols[0], vols[1], segs, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_same(got[i], want[i])
    one_t = T.BRATSVolumeDataset.single_volume(tcfg.DataConfig(**d), vols[0][0], vols[1][0],
                                               segs[0], crop=16, mode="t1")
    one_j = J.BRATSVolumeDataset.single_volume(jcfg.DataConfig(**d), vols[0][0], vols[1][0],
                                               segs[0], crop=16, mode="t1")
    assert len(one_t) == len(one_j) == 130
    assert_same(one_t[77], one_j[77])
    with pytest.raises(ValueError):
        T.BRATSVolumeDataset(tcfg.DataConfig(**d), vols[0], vols[1], slice_filter="some")


def _vol(shape=(8, 10, 12), dtype=np.int16, seed=0):
    return np.random.default_rng(seed).uniform(0, 1000, shape).astype(dtype)


MHA_DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64,
              np.uint64, np.float32, np.float64]


@pytest.mark.parametrize("dtype", MHA_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zlib"])
def test_mha_roundtrip_matches_jax(tmp_path, dtype, compressed):
    v = _vol(dtype=dtype, seed=int(np.dtype(dtype).num))
    pt, pj = str(tmp_path / "t.mha"), str(tmp_path / "j.mha")
    t_mha.save_mha(pt, v, compressed=compressed)
    j_mha.save_mha(pj, v, compressed=compressed)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    got, want = t_mha.load_mha(pt), j_mha.load_mha(pt)
    assert_same(got[0], want[0])
    assert got[1] == want[1] and got[1]["DimSize"] == "12 10 8"
    eq(got[0], v)


HDR = ("ObjectType = Image\nNDims = 3\nBinaryData = True\nBinaryDataByteOrderMSB = {msb}\n"
       "{comp}DimSize = 12 10 8\nElementType = {etype}\nElementDataFile = {data}\n")


@pytest.mark.parametrize("case", ["external_raw", "external_zraw", "big_endian", "inline_msb_zlib"])
def test_mha_layouts_match_jax(tmp_path, case):
    v = _vol(dtype=np.int16 if case != "external_raw" else np.float32, seed=5)
    etype = "MET_SHORT" if v.dtype == np.int16 else "MET_FLOAT"
    if case == "external_raw":
        (tmp_path / "vol.raw").write_bytes(v.tobytes())
        (tmp_path / "vol.mhd").write_text(HDR.format(msb="False", comp="", etype=etype,
                                                     data="vol.raw"))
        path = tmp_path / "vol.mhd"
    elif case == "external_zraw":
        (tmp_path / "vol.zraw").write_bytes(zlib.compress(v.tobytes()))
        (tmp_path / "vol.mhd").write_text(HDR.format(msb="False", comp="CompressedData = True\n",
                                                     etype=etype, data="vol.zraw"))
        path = tmp_path / "vol.mhd"
    else:
        zipped = case == "inline_msb_zlib"
        raw = v.astype(">i2").tobytes()
        path = tmp_path / "vol.mha"
        path.write_bytes(HDR.format(msb="True", comp="CompressedData = True\n" if zipped else "",
                                    etype=etype, data="LOCAL").encode()
                         + (zlib.compress(raw) if zipped else raw))
    got, want = t_mha.load_mha(str(path)), j_mha.load_mha(str(path))
    assert_same(got[0], want[0])
    assert got[0].dtype.str == want[0].dtype.str and got[1] == want[1]
    eq(got[0].astype(v.dtype), v)


def test_mha_refusals_match_jax(tmp_path):
    short = tmp_path / "short.mha"
    short.write_bytes(HDR.format(msb="False", comp="", etype="MET_SHORT", data="LOCAL").encode()
                      + b"\x00" * 10)
    bad = tmp_path / "bad.mha"
    bad.write_bytes(b"ObjectType = Image\nno equals sign\n")
    for mod in (t_mha, j_mha):
        with pytest.raises(ValueError, match="too short"):
            mod.load_mha(str(short))
        with pytest.raises(ValueError, match="malformed"):
            mod.load_mha(str(bad))


MVTEC_SETS = [dict(train=True), dict(train=False, mode=["broken"]), dict(train=False),
              dict(train=False, mode="good", max_num=1), dict(train=True, denoise=True),
              dict(train=False, denoise=True, mode=["broken"]), dict(train=True, gray=True),
              dict(train=True, max_num=3)]


@pytest.mark.parametrize("kw", MVTEC_SETS,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_mvtec_dataset_matches_jax_on_the_tree(tmp_path, kw):
    files = sorted(glob.glob(mvtec_tree(tmp_path)))
    got = T.MvtecDatasetSR(files, size=16, **kw)
    want = J.MvtecDatasetSR(files, size=16, **kw)
    assert got.items == want.items and len(got) > 0
    assert_same(got.as_arrays(), want.as_arrays())


def test_mvtec_mask_train_and_helpers_match_jax(tmp_path):
    files = sorted(glob.glob(mvtec_tree(tmp_path, n_good=3)))
    got = T.MvtecDatasetSR(files, train=True, size=16, mask_train=True, seed=4)
    want = J.MvtecDatasetSR(files, train=True, size=16, mask_train=True, seed=4)
    for i in range(len(want)):  # one generator drawn in item order: the same boxes
        assert_same(got[i], want[i])
    img = np.random.default_rng(2).uniform(0, 1, (16, 16, 3)).astype(np.float32)
    for seed in (0, 7):
        assert_same(t_mvtec.salt_and_pepper(img, seed=seed),
                    j_mvtec.salt_and_pepper(img, seed=seed))
    assert_same(t_mvtec.salt_and_pepper(img, amount=0.1, ratio=0.3, seed=1),
                j_mvtec.salt_and_pepper(img, amount=0.1, ratio=0.3, seed=1))
    assert_same(t_mvtec.sr_degrade(img), j_mvtec.sr_degrade(img))
    assert_same(t_mvtec.rgb_to_gray(img), j_mvtec.rgb_to_gray(img))
    assert_same(t_mvtec.select_patch(img, img * 2, np.random.default_rng(9)),
                j_mvtec.select_patch(img, img * 2, np.random.default_rng(9)))


@pytest.mark.parametrize("kw", [dict(), dict(horizontal_flip=True, seed=3), dict(convert=None)],
                         ids=["rgb", "flip", "source-mode"])
def test_image_folder_matches_jax(tmp_path, kw):
    from PIL import Image

    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(20, 30, 3), (32, 16, 3), (24, 24, 3)]):
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(sub / f"{i}.png")
    got = t_folder.ImageFolderDataset(str(tmp_path), image_size=12, **kw)
    want = j_folder.ImageFolderDataset(str(tmp_path), image_size=12, **kw)
    assert got.paths == want.paths and len(got) == 3
    assert_same(got.as_arrays(), want.as_arrays())


def test_package_exports_are_the_jax_packages_but_stream():
    want = {n for n in dir(J) if not n.startswith("_") and not hasattr(J.__dict__[n], "__path__")}
    want -= {"StreamLoader", "device_prefetch", "npy_shard", "stream"}
    got = {n for n in dir(T) if not n.startswith("_")}
    assert want <= got, sorted(want - got)


# ---------------------------------------------------------------------------
# the dataset functions against the JAX scripts
# ---------------------------------------------------------------------------

def _cfg(name, size, **data):
    """The port's configuration of dataset `name` at `size`, and the JAX
    package's of the same fields."""
    base = tcfg.Config()
    cfg = base.replace(data=dataclasses.replace(base.data, name=name, **data),
                       diffusion=dataclasses.replace(base.diffusion, image_size=size))
    return cfg, jax_config(cfg)


@pytest.fixture
def files(tmp_path):
    """Every dataset's files: MNIST idx, BraTS PNG cases, an MVTec tree."""
    images, labels, written = write_mnist(tmp_path / "mnist")
    brats_cases(tmp_path / "brats", n=8)
    return dict(mnist_path=images, mnist_labels_path=labels, written=written,
                mri_files=str(tmp_path / "brats" / "*_flair.png"),
                mvtec_path=mvtec_tree(tmp_path / "mvtec"))


DATASETS = [("mnist", 28), ("mnist-missing", 28), ("synthetic_brain", 16),
            ("synthetic_texture", 16), ("synthetic_texture_denoise", 16), ("synthetic", 28),
            ("mri", 32), ("mvtec", 16), ("mvtec_grid", 16)]


def _named(name, size, files, missing_dir):
    if name == "mnist-missing":
        return _cfg("mnist", size, mnist_path=os.path.join(missing_dir, "train-images"),
                    mnist_labels_path=os.path.join(missing_dir, "train-labels"))
    keys = {"mnist": ("mnist_path", "mnist_labels_path"), "mri": ("mri_files",)}.get(
        name, ("mvtec_path",) if "mvtec" in name else ())
    return _cfg(name, size, anomaly_name="broken" if "mvtec" in name else 3,
                **{k: files[k] for k in keys})


@pytest.mark.parametrize("name,size", DATASETS, ids=[d[0] for d in DATASETS])
def test_train_arrays_are_the_jax_scripts(files, tmp_path, capsys, name, size):
    cfg, jc = _named(name, size, files, str(tmp_path / "none"))
    got = D.train_arrays(cfg)
    said = capsys.readouterr().out
    want = jax_build_dataset(jc)
    assert_same(got, tuple(tuple(np.asarray(a) for a in p) for p in want))
    assert all(len(a) for p in got for a in p)
    assert ("MNIST files not found — using synthetic digits" in said) == (name == "mnist-missing")


def jax_test_arrays(cfg, max_images):
    """The JAX `scripts/test.py:108-180` branches, inline as there."""
    name = cfg.data.name
    size = cfg.diffusion.image_size
    if name == "synthetic_brain":  # :108-118
        d = cfg.data
        return J.synthetic_brain_translation(
            min(max_images, 32), size, tumor=True, seed=0, mean_t1=d.mean_t1, std_t1=d.std_t1,
            mean_flair=d.mean_flair, std_flair=d.std_flair, translate_zero=d.translate_zero)
    if name.startswith("synthetic_texture"):  # :119-134
        imgs, dmasks = j_textures(min(max_images, 16), size=size, seed=0, defect=True)
        hr = imgs * 2.0
        if name.endswith("denoise"):
            lr = np.stack([j_mvtec.salt_and_pepper(im / 2.0, seed=i) * 2.0
                           for i, im in enumerate(hr)])
        else:
            lr = np.stack([j_mvtec.sr_degrade(im) for im in hr])
        return hr, lr, dmasks
    if name == "mnist":  # :135-148
        try:
            imgs, labels = J.load_mnist_arrays(
                cfg.data.mnist_path.replace("train-", "t10k-"),
                cfg.data.mnist_labels_path.replace("train-", "t10k-"))
        except (FileNotFoundError, OSError):
            imgs, labels = J.synthetic_digits(256, size=size, seed=0)
        ds = J.MNISTDataset(imgs, labels, num=[cfg.data.anomaly_name], max_file=max_images)
        hr, lr, _ = ds.as_arrays()
        return hr, lr, None
    if name != "mri" and "mvtec" not in name:
        raise NotImplementedError(f"unknown dataset {name}")  # :179-180
    files = np.array(sorted(glob.glob(cfg.data.mri_files if name == "mri"
                                      else cfg.data.mvtec_path)))
    np.random.seed(42)
    np.random.shuffle(files)
    if name == "mri":  # :149-163
        split = int(0.5 * len(files))
        ds = J.BRATSPngDataset(cfg.data, files[split:], train=False, tumor=True, crop=size,
                               max_test=max_images, mode="t1")
        return ds.as_arrays()
    ds = J.MvtecDatasetSR(files, train=False, mode=[str(cfg.data.anomaly_name)],  # :164-178
                          size=size, max_num=max_images)
    hr, lr, _, _ = ds.as_arrays()
    return hr, lr, None


@pytest.mark.parametrize("max_images", [3, 40])
@pytest.mark.parametrize("name,size", DATASETS, ids=[d[0] for d in DATASETS])
def test_test_arrays_are_the_jax_scripts(files, tmp_path, capsys, name, size, max_images):
    cfg, jc = _named(name, size, files, str(tmp_path / "none"))
    if name == "synthetic":  # no branch in the JAX script
        for fn, c in ((D.test_arrays, cfg), (jax_test_arrays, jc)):
            with pytest.raises(NotImplementedError, match="unknown dataset"):
                fn(c, max_images)
        return
    got = D.test_arrays(cfg, max_images)
    said = capsys.readouterr().out
    want = jax_test_arrays(jc, max_images)
    assert (got[2] is None) == (want[2] is None)
    assert_same(tuple(a for a in got if a is not None), tuple(a for a in want if a is not None))
    assert 0 < len(got[0]) <= max_images
    assert ("MNIST test files not found — synthetic" in said) == (name == "mnist-missing")


def jax_bank_images(cfg, n):
    """The JAX `scripts/anomaly_model_train.py:69-118` branches, inline."""
    name = cfg.data.name
    if name == "mnist":  # :69-79
        try:
            imgs, labels = J.load_mnist_arrays(cfg.data.mnist_path, cfg.data.mnist_labels_path)
        except (FileNotFoundError, OSError):
            imgs, labels = J.synthetic_digits(512, seed=42)
        return J.MNISTDataset(imgs, labels, num=[8], max_file=n).as_arrays()[1]
    if name == "synthetic_texture":  # :80-86
        imgs, _ = j_textures(n, size=cfg.diffusion.image_size, seed=42)
        return np.stack([j_mvtec.sr_degrade(im * 2.0) for im in imgs])
    if name == "synthetic_brain":  # :87-94
        d = cfg.data
        return J.synthetic_brain_translation(
            n, cfg.diffusion.image_size, tumor=False, seed=42, mean_t1=d.mean_t1,
            std_t1=d.std_t1, mean_flair=d.mean_flair, std_flair=d.std_flair)[1]
    if name == "mri":  # :95-105
        files = np.array(sorted(glob.glob(cfg.data.mri_files)))
        np.random.seed(42)
        np.random.shuffle(files)
        return J.BRATSPngDataset(cfg.data, files[:n], train=True,
                                 crop=cfg.diffusion.image_size).as_arrays()[1]
    if "mvtec" in name:  # :106-115
        files = np.array(sorted(glob.glob(cfg.data.mvtec_path)))
        return J.MvtecDatasetSR(files, train=True, size=cfg.diffusion.image_size,
                                max_num=n).as_arrays()[1]
    raise NotImplementedError(f"unknown dataset {name}")  # :116-117


@pytest.mark.parametrize("n", [5, 200])
@pytest.mark.parametrize("name,size", DATASETS, ids=[d[0] for d in DATASETS])
def test_bank_images_are_the_jax_scripts(files, tmp_path, name, size, n):
    cfg, jc = _named(name, size, files, str(tmp_path / "none"))
    if name in ("synthetic_texture_denoise", "synthetic"):  # no branch in the JAX script
        for fn, c in ((D.bank_images, cfg), (jax_bank_images, jc)):
            with pytest.raises(NotImplementedError, match="unknown dataset"):
                fn(c, n)
        return
    if name == "mri":
        n = min(n, 4)  # the JAX branch reads files[:n]: at least one tumour-free case
    got = D.bank_images(cfg, n)
    assert_same(got, jax_bank_images(jc, n))
    assert 0 < len(got) <= n


def test_unknown_dataset_raises_in_every_function():
    cfg, _ = _cfg("imagenet", 16)
    for fn in (D.train_arrays, lambda c: D.test_arrays(c, 2), lambda c: D.bank_images(c, 2)):
        with pytest.raises(NotImplementedError, match="unknown dataset imagenet"):
            fn(cfg)


def test_readers_that_decode_images_name_pil_when_it_is_missing(tmp_path, monkeypatch):
    """Without PIL (the card's machine) a BraTS, MVTec or folder read raises
    ImportError naming PIL: nothing stands in for the decoder."""
    flairs = brats_cases(tmp_path / "b", n=2)
    pattern = mvtec_tree(tmp_path / "m", n_good=1, n_defect=1)
    monkeypatch.setitem(sys.modules, "PIL", None)
    reads = [lambda: T.BRATSPngDataset(tcfg.DataConfig(), flairs, train=False, tumor=True)[0],
             lambda: T.MvtecDatasetSR(sorted(glob.glob(pattern)), train=True)[0],
             lambda: t_folder.ImageFolderDataset(str(tmp_path / "m"), 8)[0]]
    for read in reads:
        with pytest.raises(ImportError, match="PIL"):
            read()
    # the MNIST reader needs no decoder
    images, labels, _ = write_mnist(tmp_path, n=20)
    assert T.load_mnist_arrays(images, labels)[0].shape == (20, 28, 28)


# ---------------------------------------------------------------------------
# the entry points' datasets, on the CPU at a narrow width
# ---------------------------------------------------------------------------

def _narrow(base: tcfg.Config, timesteps=3) -> tcfg.Config:
    """`base` with the narrow UNet (dim 8, mults 1/2) at its own channels
    and size, T=`timesteps`, float32."""
    model = dataclasses.replace(small_model_cfg(), channels=base.model.channels)
    return base.replace(model=model,
                        diffusion=dataclasses.replace(base.diffusion, timesteps=timesteps),
                        train=dataclasses.replace(base.train, compute_dtype="float32"))


@pytest.fixture
def narrow(monkeypatch):
    for name in ("mnist_train", "mnist_8to5", "mnist_gated", "mvtec_synthetic", "mvtec_denoise"):
        monkeypatch.setitem(tcfg.CONFIGS, "narrow_" + name,
                            lambda b=tcfg.CONFIGS[name]: _narrow(b()))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bank_cli_on_mnist_files_and_its_texture_denoise_raise(narrow, tmp_path, capsys):
    images, labels, written = write_mnist(tmp_path, n=200)
    out = str(tmp_path / "bank.npy")
    res = bank_cli.main(["--config", "narrow_mnist_gated", "--out", out, "--n-images", "2",
                         "--mnist-path", images, "--mnist-labels-path", labels, "--device",
                         "cpu"])
    assert res["bank"].shape[1] == 512 + 1024  # WRN50-2 layer2 ⊕ layer3
    assert os.path.exists(out) and os.path.exists(str(tmp_path / "bank_ladder.json"))
    cfg = tcfg.Config(data=tcfg.DataConfig(mnist_path=images, mnist_labels_path=labels))
    eighths = written["train"][1] == 8
    want = J.MNISTDataset(*written["train"], num=[8], max_file=2).as_arrays()[1]
    assert eighths.sum() >= 2
    assert_same(D.bank_images(cfg, 2), want)
    with pytest.raises(NotImplementedError, match="synthetic_texture_denoise"):
        bank_cli.main(["--config", "narrow_mvtec_denoise", "--out", out, "--device", "cpu"])


def test_train_and_test_clis_on_mnist_idx_files(narrow, tmp_path, capsys):
    images, labels, written = write_mnist(tmp_path, n=300)
    npz = str(tmp_path / "ema.npz")
    data = ["--mnist-path", images, "--mnist-labels-path", labels]
    out = train_cli.main(["--config", "narrow_mnist_train", "--steps", "1", "--step-mode",
                          "epoch", "--batch-size", "8", "--results", str(tmp_path / "r"),
                          "--export-npz", npz, "--device", "cpu"] + data)
    said = capsys.readouterr().out
    assert out["step"] == 1 and "synthetic" not in said
    n8 = int((written["train"][1][: int(0.7 * 300)] == 8).sum())
    assert f"train {n8} / test" in said
    res = test_cli.main(["--config", "narrow_mnist_8to5", "--params-npz", npz, "--max-images",
                         "2", "--device", "cpu"] + data)
    want = J.MNISTDataset(*written["t10k"], num=[5], max_file=2).as_arrays()
    assert_same(res["hr_all"], want[0])
    assert_same(res["lr_all"], want[1])
    assert res["pred_all"].shape == (2, 28, 28, 1) and np.isfinite(res["pred_all"]).all()
    assert "mean_mse_ood_region" not in res  # MNIST has no ground-truth masks


def test_train_and_test_clis_on_synthetic_textures(narrow, monkeypatch, tmp_path):
    for name in ("mvtec_synthetic", "mvtec_denoise"):  # 16px: cheap on the CPU
        monkeypatch.setitem(tcfg.CONFIGS, "narrow_" + name, lambda b=tcfg.CONFIGS[name]: (
            lambda c: c.replace(diffusion=dataclasses.replace(c.diffusion, image_size=16)))(
                _narrow(b())))
    npz = str(tmp_path / "ema.npz")
    out = train_cli.main(["--config", "narrow_mvtec_synthetic", "--steps", "1", "--step-mode",
                          "batch", "--results", str(tmp_path / "r"), "--export-npz", npz,
                          "--device", "cpu"])
    assert out["step"] == 1
    for name in ("mvtec_synthetic", "mvtec_denoise"):
        res = test_cli.main(["--config", "narrow_" + name, "--params-npz", npz,
                             "--max-images", "2", "--device", "cpu"])
        hr, lr, masks = D.test_arrays(tcfg.CONFIGS["narrow_" + name](), 2)
        assert_same(res["lr_all"], lr)
        assert res["pred_all"].shape == (2, 16, 16, 3) and np.isfinite(res["pred_all"]).all()
        assert np.isfinite(float(res["mean_mse_ood_region"]))  # the defect masks as gt
