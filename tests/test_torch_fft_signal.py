"""``paddle_tpu_torch.fft`` and ``paddle_tpu_torch.signal`` against the
reference's (``paddle_tpu/fft.py``, ``paddle_tpu/signal.py``) on the CPU:
every transform, shift and frequency helper, ``frame``/``overlap_add``
on both axes, and ``stft``/``istft`` with the reference's centre
padding, window padding, ``normalized`` and ``onesided`` handling, on the
same seeded numpy inputs, plus the gradients of an rfft and an stft.
Bounds are the reference tests' own (``test_fft_sparse_dist.py``,
``test_signal_unpool.py``): rtol 1e-4, atol 1e-4; framing is exact."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    v = t._value if hasattr(t, "_value") else t
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _both(mod, name, *arrays, **kw):
    out = []
    for pkg in (J, TP):
        f = getattr(getattr(pkg, mod), name)
        out.append(_np(f(*[pkg.to_tensor(a) if isinstance(a, np.ndarray)
                           else a for a in arrays], **kw)))
    return out


R = np.random.RandomState(0)
X1 = R.randn(4, 16).astype(np.float32)
X3 = R.randn(2, 6, 8).astype(np.float32)
C1 = (R.randn(4, 9) + 1j * R.randn(4, 9)).astype(np.complex64)

FFT_CASES = {
    "fft": ("fft", X1, {}), "fft_n": ("fft", X1, {"n": 10, "axis": 0}),
    "ifft": ("ifft", C1, {}), "rfft": ("rfft", X1, {"norm": "ortho"}),
    "irfft": ("irfft", C1, {"n": 16}), "hfft": ("hfft", C1, {}),
    "ihfft": ("ihfft", X1, {"norm": "forward"}),
    "fft2": ("fft2", X3, {}), "ifft2": ("ifft2", X3, {"s": (4, 4)}),
    "rfft2": ("rfft2", X3, {"axes": (0, 2)}), "irfft2": ("irfft2", X3, {}),
    "fftn": ("fftn", X3, {}), "ifftn": ("ifftn", X3, {"axes": (1,)}),
    "rfftn": ("rfftn", X3, {"norm": "ortho"}),
    "irfftn": ("irfftn", X3, {"s": (6, 10), "axes": (1, 2)}),
    "fftshift": ("fftshift", X1, {}),
    "ifftshift": ("ifftshift", X3, {"axes": (1,)}),
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_matches_the_reference(case):
    name, x, kw = FFT_CASES[case]
    ref, got = _both("fft", name, x, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, **TOL)


def test_frequencies_and_bad_norm():
    for name in ("fftfreq", "rfftfreq"):
        ref = _np(getattr(J.fft, name)(9, d=0.5))
        got = _np(getattr(TP.fft, name)(9, d=0.5))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert got.dtype == ref.dtype
    with pytest.raises(ValueError):
        TP.fft.fft(TP.to_tensor(X1), norm="bogus")


def test_rfft_gradient_matches():
    grads = []
    for pkg in (J, TP):
        x = pkg.to_tensor(X1[0])
        x.stop_gradient = False
        (pkg.fft.rfft(x).abs() ** 2).sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("shape", [(40,), (3, 40)])
def test_frame_and_overlap_add(axis, shape):
    x = R.randn(*shape).astype(np.float32)
    if axis == 0:
        x = np.ascontiguousarray(np.moveaxis(x, -1, 0))
    ref, got = _both("signal", "frame", x, 10, 5, axis=axis)
    np.testing.assert_array_equal(got, ref)
    r2, g2 = _both("signal", "overlap_add", ref, 5, axis=axis)
    np.testing.assert_allclose(g2, r2, **TOL)


def test_frame_errors():
    with pytest.raises(ValueError):
        TP.signal.frame(TP.to_tensor(X1), 8, 4, axis=1)
    with pytest.raises(ValueError):
        TP.signal.frame(TP.to_tensor(X1), 40, 4)


STFT_CASES = {
    "default": dict(n_fft=16),
    "hop_win": dict(n_fft=16, hop_length=3, win_length=10),
    "window": dict(n_fft=16, hop_length=4, window="hann"),
    "no_center": dict(n_fft=8, hop_length=2, center=False),
    "constant_pad": dict(n_fft=16, pad_mode="constant"),
    "normalized": dict(n_fft=16, normalized=True, window="hann"),
    "twosided": dict(n_fft=16, onesided=False, window="hann"),
}


def _window(n):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(STFT_CASES))
def test_stft_and_istft_match_the_reference(case):
    kw = dict(STFT_CASES[case])
    x = R.randn(2, 64).astype(np.float32)
    win = kw.pop("window", None)
    wl = kw.get("win_length") or kw["n_fft"]
    specs = []
    for pkg in (J, TP):
        w = pkg.to_tensor(_window(wl)) if win else None
        specs.append(pkg.signal.stft(pkg.to_tensor(x), window=w, **kw))
    ref, got = (_np(s) for s in specs)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, **TOL)
    if not kw.get("center", True):
        return
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    outs = []
    for pkg, spec in zip((J, TP), specs):
        w = pkg.to_tensor(_window(wl)) if win else None
        outs.append(_np(pkg.signal.istft(spec, window=w, length=64, **ikw)))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    if win:
        np.testing.assert_allclose(outs[1], x, **TOL)


def test_stft_of_a_complex_signal_and_errors():
    z = (R.randn(40) + 1j * R.randn(40)).astype(np.complex64)
    ref, got = _both("signal", "stft", z, 8, onesided=False)
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError):
        TP.signal.stft(TP.to_tensor(z), 8)                 # onesided complex
    with pytest.raises(ValueError):
        TP.signal.stft(TP.to_tensor(X1[0]), 32, center=False)
    with pytest.raises(ValueError):
        TP.signal.istft(TP.to_tensor(C1), 16, return_complex=True)


def test_stft_gradient_matches():
    grads = []
    for pkg in (J, TP):
        x = pkg.to_tensor(X1)
        x.stop_gradient = False
        (pkg.signal.stft(x, 8, hop_length=2).abs() ** 2).sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-3)
