"""``paddle_tpu_torch.audio`` and ``paddle_tpu_torch.text`` against the
reference's on the CPU, on the same seeded inputs: the mel scales both
ways (Slaney and HTK, scalars and tensors), the filterbank under each
norm, ``power_to_db``, the DCT, every window, the Spectrogram,
MelSpectrogram, LogMelSpectrogram and MFCC layers (their buffers and
forwards), the WAV backend written by one package and read by the
other, and Viterbi decoding (``viterbi_decode`` and ``ViterbiDecoder``
with the transition weights carried across through numpy), with and
without BOS/EOS tags and at ragged lengths. Bounds are the reference
test's own (``test_api_sweep5.py``): rtol 2e-4, atol 2e-4 for the
features, 1e-4 for scores; paths are equal."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=2e-4, atol=2e-4)


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


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scales(htk):
    freqs = np.array([0.0, 60.0, 440.0, 999.0, 1000.0, 4000.0, 11025.0],
                     np.float32)
    for f in (60.0, 440.0, 1000.0, 4000.0):
        r = J.audio.functional.hz_to_mel(f, htk=htk)
        t = TP.audio.functional.hz_to_mel(f, htk=htk)
        assert isinstance(t, float)
        np.testing.assert_allclose(t, r, rtol=1e-6)
        np.testing.assert_allclose(TP.audio.functional.mel_to_hz(t, htk=htk),
                                   J.audio.functional.mel_to_hz(r, htk=htk),
                                   rtol=1e-5)
    out = []
    for pkg in (J, TP):
        F = pkg.audio.functional
        m = F.hz_to_mel(pkg.to_tensor(freqs), htk=htk)
        out.append([_np(m), _np(F.mel_to_hz(m, htk=htk)),
                    _np(F.mel_frequencies(10, 20.0, 8000.0, htk=htk)),
                    _np(F.fft_frequencies(16000, 64))])
    for r, g in zip(*out):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("norm", ["slaney", 1.0, 2.0, None])
@pytest.mark.parametrize("htk", [False, True])
def test_fbank_matrix(norm, htk):
    out = [_np(pkg.audio.functional.compute_fbank_matrix(
        16000, 512, n_mels=40, f_min=20.0, htk=htk, norm=norm))
        for pkg in (J, TP)]
    assert out[1].shape == out[0].shape == (40, 257)
    # the ramps cancel near a filter's feet, where torch's linspace (from
    # both ends) and jnp's round the mel points differently
    np.testing.assert_allclose(out[1], out[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("top_db", [None, 15.0, 80.0])
def test_power_to_db_and_dct(top_db):
    x = np.abs(np.random.RandomState(0).randn(3, 20)).astype(np.float32) ** 3
    out = [_np(pkg.audio.functional.power_to_db(
        pkg.to_tensor(x), ref_value=2.0, amin=1e-6, top_db=top_db))
        for pkg in (J, TP)]
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-4)
    for norm in ("ortho", None):
        d = [_np(pkg.audio.functional.create_dct(13, 40, norm=norm))
             for pkg in (J, TP)]
        np.testing.assert_allclose(d[1], d[0], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TP.audio.functional.power_to_db(TP.to_tensor(x), amin=0.0)


WINDOWS = ["hann", "hamming", "blackman", "bartlett", ("kaiser", 8.0),
           ("gaussian", 3.0), ("general_gaussian", 1.5, 4.0),
           ("exponential", None, 2.0), "triang", "bohman"]


@pytest.mark.parametrize("fftbins", [True, False])
@pytest.mark.parametrize("window", WINDOWS, ids=[str(w) for w in WINDOWS])
def test_windows(window, fftbins):
    for n in (31, 32):
        out = [_np(pkg.audio.functional.get_window(window, n,
                                                   fftbins=fftbins))
               for pkg in (J, TP)]
        np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="taylor"):
        TP.audio.functional.get_window("taylor", 8)


X = np.random.RandomState(1).randn(2, 3000).astype(np.float32)
LAYERS = {
    "Spectrogram": lambda F: F.Spectrogram(n_fft=256, hop_length=80,
                                           win_length=200),
    "Spectrogram_mag": lambda F: F.Spectrogram(n_fft=128, power=1.0,
                                               window="hamming"),
    "MelSpectrogram": lambda F: F.MelSpectrogram(sr=8000, n_fft=256,
                                                 n_mels=32),
    "LogMelSpectrogram": lambda F: F.LogMelSpectrogram(
        sr=8000, n_fft=256, n_mels=32, top_db=80.0),
    "MFCC": lambda F: F.MFCC(sr=16000, n_mfcc=13, n_fft=256, n_mels=32,
                             htk=True, norm=2.0),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_feature_layers(name):
    out = []
    for pkg in (J, TP):
        layer = LAYERS[name](pkg.audio.features)
        out.append(_np(layer(pkg.to_tensor(X))))
    assert out[1].shape == out[0].shape
    scale = max(1.0, float(np.abs(out[0]).max()))
    np.testing.assert_allclose(out[1] / scale, out[0] / scale, **TOL)


def test_feature_layer_buffers():
    rl = J.audio.features.MFCC(sr=16000, n_mfcc=13, n_fft=256, n_mels=32)
    tl = TP.audio.features.MFCC(sr=16000, n_mfcc=13, n_fft=256, n_mels=32)
    np.testing.assert_allclose(_np(tl.dct_matrix), _np(rl.dct_matrix),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TP.audio.features.MFCC(n_mfcc=80, n_mels=64)


@pytest.mark.parametrize("writer,reader", [(J, TP), (TP, J)],
                         ids=["ref_to_port", "port_to_ref"])
def test_wav_backend_across_packages(writer, reader, tmp_path):
    x = (0.5 * np.sin(np.arange(1600) * 0.1)).astype(np.float32)
    x = np.stack([x, -x])
    p = str(tmp_path / "t.wav")
    writer.audio.backends.save(p, writer.to_tensor(x), 8000)
    w, sr = reader.audio.backends.load(p)
    assert sr == 8000 and tuple(w.shape) == (2, 1600)
    np.testing.assert_allclose(_np(w), x, atol=1e-4)
    w2, _ = writer.audio.backends.load(p, frame_offset=100, num_frames=50,
                                       channels_first=False)
    w3, _ = reader.audio.backends.load(p, frame_offset=100, num_frames=50,
                                       channels_first=False)
    np.testing.assert_array_equal(_np(w3), _np(w2))
    meta = reader.audio.backends.info(p)
    assert (meta.sample_rate, meta.num_channels, meta.num_frames,
            meta.bits_per_sample) == (8000, 2, 1600, 16)
    assert TP.audio.backends.list_available_backends() == \
        J.audio.backends.list_available_backends()
    with pytest.raises(ValueError):
        TP.audio.backends.set_backend("soundfile")


@pytest.mark.parametrize("bos_eos", [True, False])
@pytest.mark.parametrize("T", [1, 7])
def test_viterbi_decode(bos_eos, T):
    rs = np.random.RandomState(3)
    B, C = 4, 6
    emis = rs.randn(B, T, C).astype(np.float32)
    trans = rs.randn(C, C).astype(np.float32)
    lens = np.array([T, max(T - 2, 1), 1, T], np.int32)
    out = []
    for pkg in (J, TP):
        s, p = pkg.text.viterbi_decode(pkg.to_tensor(emis),
                                       pkg.to_tensor(trans),
                                       pkg.to_tensor(lens),
                                       include_bos_eos_tag=bos_eos)
        dec = pkg.text.ViterbiDecoder(pkg.to_tensor(trans), bos_eos)
        s2, p2 = dec(pkg.to_tensor(emis), pkg.to_tensor(lens))
        out.append((_np(s), _np(p), _np(s2), _np(p2)))
    (rs_, rp, rs2, rp2), (ts, tp, ts2, tp2) = out
    np.testing.assert_allclose(ts, rs_, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tp, rp)
    assert tp.dtype == rp.dtype
    np.testing.assert_allclose(ts2, rs2, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tp2, rp2)
