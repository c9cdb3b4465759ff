"""``paddle_tpu_torch.vision``'s models, transforms and datasets against
the JAX package's on the CPU (the cases of ``tests/test_vision.py``).

Models: built in both packages, the port's weights carried by
``set_state_dict`` from the reference's ``state_dict``; the same seeded
numpy images go through both. The forwards are compared in eval mode
(a training-mode BatchNorm over a 1×1 map of two images divides each
value by a spread of two, which magnifies the two packages' fp32
convolution sums); ResNet-18's loss, gradients and running statistics
are compared after a training-mode step on 4 images of 64². Bound
``OUT``: fp32 convolutions summed in other orders. Transforms and
datasets are numpy on both sides: equal arrays, the seeded random
transforms included."""

import gzip
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as _place
from paddle_tpu.vision import datasets as JDS
from paddle_tpu.vision import models as JM
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch.vision import datasets as TDS
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision import transforms as TT
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


@pytest.fixture(autouse=True)
def _cpu_place():
    """The CPU is this file's place; the next file's is left as found."""
    prev = _place._current_place[0]
    tp.set_device("cpu")
    yield
    _place._current_place[0] = prev

OUT = dict(rtol=1e-4, atol=1e-4)


def _np(a):
    v = getattr(a, "_value", a)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _pair(name, **kw):
    """The reference model (seed 0) and the port's with its weights."""
    jp.seed(0)
    jm = getattr(JM, name)(**kw)
    tm = getattr(TM, name)(**kw)
    missing, unexpected = tm.set_state_dict(
        {k: _np(v) for k, v in jm.state_dict().items()})
    assert not missing and not unexpected
    return jm, tm


def _img(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name,kw,shape", [
    ("resnet50", dict(num_classes=8), (1, 3, 32, 32)),
    ("resnext50_32x4d", dict(num_classes=4), (1, 3, 32, 32)),
    ("resnet34", dict(num_classes=0), (1, 3, 32, 32)),
    ("vgg11", dict(num_classes=0, batch_norm=True, with_pool=False),
     (1, 3, 32, 32)),
    ("mobilenet_v1", dict(scale=0.25, num_classes=6), (2, 3, 32, 32)),
    ("mobilenet_v2", dict(scale=0.25, num_classes=6), (2, 3, 32, 32)),
    ("LeNet", dict(), (2, 1, 28, 28)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_model_forward_matches_jax(name, kw, shape):
    jm, tm = _pair(name, **kw)
    jm.eval()
    tm.eval()
    x = _img(shape)
    want = _np(jm(jp.to_tensor(x)))
    got = tm(tp.to_tensor(x))
    assert list(got.shape) == list(want.shape)
    np.testing.assert_allclose(_np(got), want, **OUT)


def test_resnet18_gradients_and_running_stats_after_a_step():
    """ResNet-18: the loss, every parameter's gradient and, after an SGD
    step, the weights and BatchNorm running statistics agree."""
    jm, tm = _pair("resnet18", num_classes=10)
    x = _img((4, 3, 64, 64), 1)
    y = np.array([3, 7, 0, 9], np.int64)
    res = []
    for pkg, m in ((jp, jm), (tp, tm)):
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=m.parameters())
        loss = pkg.nn.functional.cross_entropy(m(pkg.to_tensor(x)),
                                               pkg.to_tensor(y))
        loss.backward()
        grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        opt.step()
        res.append((float(_np(loss)), grads,
                    {k: _np(v) for k, v in m.state_dict().items()}))
    (jl, jg, js), (tl, tg, ts) = res
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jg.keys() == tg.keys()
    # each gradient as a share of its largest element: 20 training-mode
    # BatchNorms (the last over 16 values a channel) carry the fp32
    # summation differences of the forward into the backward: measured
    # 1.7e-3 of the largest element (6 of layer1.0.conv2's 36864) and a
    # relative L2 of 2.7e-4 (conv1) at most; a wrong term moves a
    # gradient by far more
    for k in jg:
        scale = np.abs(jg[k]).max() + 1e-6
        np.testing.assert_allclose(tg[k] / scale, jg[k] / scale,
                                   rtol=0, atol=5e-3, err_msg=k)
        rel = np.linalg.norm(tg[k] - jg[k]) / (np.linalg.norm(jg[k]) + 1e-9)
        assert rel < 1e-3, (k, rel)
    assert "bn1._mean" in ts
    # the weights move by lr (0.1) times those gradients; the running
    # statistics are the forward's batch statistics
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_lenet_train_step_matches_jax():
    jm, tm = _pair("LeNet")
    x = _img((4, 1, 28, 28), 2)
    y = np.array([0, 1, 2, 3], np.int64)
    after = []
    for pkg, m in ((jp, jm), (tp, tm)):
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=m.parameters())
        before = _np(m.fc[0].weight).copy()
        loss = pkg.nn.functional.cross_entropy(m(pkg.to_tensor(x)),
                                               pkg.to_tensor(y))
        loss.backward()
        opt.step()
        assert not np.allclose(before, _np(m.fc[0].weight))
        after.append({n: _np(p) for n, p in m.named_parameters()})
    for k in after[0]:
        np.testing.assert_allclose(after[1][k], after[0][k], **OUT,
                                   err_msg=k)


def test_model_surface_names():
    """The constructors and classes of the reference's ``vision`` and
    ``vision.models``."""
    import paddle_tpu.vision as JV
    import paddle_tpu_torch.vision as TV
    for mod_j, mod_t in ((JV, TV), (JM, TM)):
        names = {n for n in dir(mod_j) if not n.startswith("_")}
        assert names <= set(dir(mod_t)), names - set(dir(mod_t))
    with pytest.raises(ValueError, match="pretrained"):
        TM.resnet18(pretrained=True)


def test_wide_and_resnext_constructors(monkeypatch):
    """The wide and ResNeXt constructors pass the reference's widths and
    groups (building a wide ResNet-50 draws 68 M weights: the
    arguments are checked instead)."""
    seen = []
    monkeypatch.setattr(TM.resnet, "ResNet",
                        lambda **kw: seen.append(kw) or kw)
    TM.wide_resnet50_2(num_classes=4)
    TM.wide_resnet101_2()
    TM.resnext50_32x4d()
    TM.resnext101_64x4d()
    assert seen == [dict(depth=50, width=128, num_classes=4),
                    dict(depth=101, width=128),
                    dict(depth=50, groups=32, width=4),
                    dict(depth=101, groups=64, width=4)]


# ---------------------------------------------------------------------------
# transforms: numpy on both sides, the same arrays
# ---------------------------------------------------------------------------

def _u8(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("call", [
    ("to_tensor", (), {}), ("to_tensor", ("HWC",), {}),
    ("resize", ((5, 7),), {}), ("resize", (6,), {}),
    ("resize", ((9, 4), "nearest"), {}),
    ("center_crop", (5,), {}), ("crop", (1, 2, 4, 5), {}),
    ("hflip", (), {}), ("vflip", (), {}),
    ("pad", (2,), {}), ("pad", ((1, 2),), {"fill": 7}),
    ("pad", ((1, 2, 3, 0),), {"padding_mode": "reflect"}),
    ("adjust_brightness", (1.3,), {}), ("adjust_contrast", (0.6,), {}),
    ("rotate", (33,), {}), ("to_grayscale", (3,), {}),
], ids=lambda c: f"{c[0]}{len(c[1])}{sorted(c[2])}")
def test_functional_transforms_equal_jax(call):
    name, args, kw = call
    img = _u8((10, 12, 3))
    np.testing.assert_array_equal(getattr(TT.F, name)(img, *args, **kw),
                                  getattr(JT.F, name)(img, *args, **kw))


def test_normalize_equals_jax():
    img = np.random.RandomState(1).rand(3, 4, 5).astype(np.float32)
    for fmt in ("CHW", "HWC"):
        x = img if fmt == "CHW" else img.transpose(1, 2, 0)
        np.testing.assert_array_equal(
            TT.F.normalize(x, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4], fmt),
            JT.F.normalize(x, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4], fmt))


def _pipeline(T):
    return T.Compose([
        T.RandomResizedCrop(12), T.RandomCrop(10, padding=2),
        T.RandomHorizontalFlip(), T.RandomVerticalFlip(),
        T.BrightnessTransform(0.4), T.ContrastTransform(0.4),
        T.RandomRotation(20), T.Grayscale(3), T.Resize((8, 9)),
        T.Pad(1), T.CenterCrop(8), T.ToTensor(),
        T.Normalize([0.5, 0.5, 0.5], [0.5, 0.5, 0.5], to_rgb=True),
    ])


def test_seeded_random_pipeline_gives_the_jax_arrays():
    """A seeded pipeline of every random transform draws from Python's
    ``random`` in the reference's order: the same crops, flips,
    factors and angles, so the same arrays, image after image."""
    imgs = [_u8((20, 24, 3), s) for s in range(6)]
    out = []
    for T in (JT, TT):
        random.seed(123)
        pipe = _pipeline(T)
        out.append([pipe(im) for im in imgs])
    for a, b in zip(*out):
        assert a.shape == (3, 8, 8)
        np.testing.assert_array_equal(b, a)


def test_transform_keys_and_transpose():
    img = _u8((6, 6, 3))
    for T in (JT, TT):
        t = T.Transpose(keys=("image", "label"))
        got = t((img, 5))
    np.testing.assert_array_equal(got[0], JT.Transpose()(img))
    assert got[1] == 5


# ---------------------------------------------------------------------------
# datasets: local files the test writes; nothing downloads
# ---------------------------------------------------------------------------

def test_fake_data_equals_jax_and_loads():
    kw = dict(size=8, image_shape=(8, 8, 3), num_classes=4, seed=3)
    jds, tds = JDS.FakeData(**kw), TDS.FakeData(**kw)
    for i in range(len(jds)):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    tf = TDS.FakeData(**kw, transform=TT.ToTensor())
    loader = tp.io.DataLoader(tf, batch_size=4, shuffle=False)
    xb, yb = next(iter(loader))
    assert list(xb.shape) == [4, 3, 8, 8] and list(yb.shape) == [4]


def test_dataset_folder_and_image_folder(tmp_path):
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            np.save(d / f"{i}.npy", rng.randint(0, 255, (2, 2, 3)).astype(
                np.uint8))
        (d / "notes.txt").write_text("skipped")
    jds = JDS.DatasetFolder(str(tmp_path))
    tds = TDS.DatasetFolder(str(tmp_path), transform=TT.ToTensor())
    assert len(tds) == 6 and tds.class_to_idx == {"cat": 0, "dog": 1}
    assert [p for p, _ in tds.samples] == [p for p, _ in jds.samples]
    img, label = tds[5]
    np.testing.assert_array_equal(img, JT.ToTensor()(jds[5][0]))
    assert int(label) == 1
    assert len(TDS.ImageFolder(str(tmp_path))) == 6


def _write_mnist(path, n=5):
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    with gzip.open(path / "img.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(path / "lab.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(path / "img.gz"), str(path / "lab.gz"), imgs, labels


def test_mnist_reads_a_local_file(tmp_path):
    ip, lp, imgs, labels = _write_mnist(tmp_path)
    ds = TDS.MNIST(ip, lp, transform=TT.Normalize(127.5, 127.5, "HWC"))
    jds = JDS.MNIST(ip, lp, transform=JT.Normalize(127.5, 127.5, "HWC"))
    assert len(ds) == 5 and TDS.FashionMNIST is TDS.MNIST
    for i in range(5):
        img, lab = ds[i]
        np.testing.assert_array_equal(img, jds[i][0])
        assert int(lab) == labels[i]
    with pytest.raises(RuntimeError, match="offline"):
        TDS.MNIST(str(tmp_path / "missing.gz"), lp)
    with pytest.raises(RuntimeError, match="offline"):
        TDS.Cifar10(str(tmp_path / "missing.tar.gz"))


def test_cifar_reads_a_local_tarball(tmp_path):
    rng = np.random.RandomState(8)
    path = tmp_path / "cifar.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("data_batch_1", 4), ("data_batch_2", 3),
                        ("test_batch", 2)):
            blob = pickle.dumps({b"data": rng.randint(0, 256, (n, 3072))
                                 .astype(np.uint8),
                                 b"labels": list(rng.randint(0, 10, n))})
            f = tmp_path / name
            f.write_bytes(blob)
            tf.add(f, arcname=f"cifar/{name}")
    for mode, n in (("train", 7), ("test", 2)):
        ds = TDS.Cifar10(str(path), mode=mode)
        jds = JDS.Cifar10(str(path), mode=mode)
        assert len(ds) == n
        for i in range(n):
            np.testing.assert_array_equal(ds[i][0], jds[i][0])
            assert ds[i][1] == jds[i][1]
    assert TDS.Cifar100._n_classes == 100
