"""The port's WAV I/O (``mars5_tts_torch/audio/io.py``) against the JAX
package's copy, bitwise, and its inverse STFT against scipy.

* ``read_wav`` of PCM8/16/24/32 files, mono and stereo, at several sample
  rates, with and without resampling to 24 kHz; ``resample_linear`` over
  rate pairs; ``float_to_pcm16`` with values past the clip at several
  scales; ``write_wav``'s bytes: all equal to the JAX functions' output.
* ``models/vocos.istft_same`` at the released n_fft 1280 / hop 320 against
  ``scipy.signal.istft`` (Hann, the same overlap, no boundary padding,
  cropped by (n_fft - hop) / 2 a side): within atol 1e-6 on a spectrum of
  unit-normal bins (f32 against f64; the largest difference seen is 3e-8).
"""

import wave
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from mars5_tts_torch.audio import io as P  # noqa: E402
from mars5_tts_tpu.audio import io as J  # noqa: E402

ISTFT_ATOL = 1e-6


def _pcm_bytes(rng, n, width):
    if width == 1:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if width == 2:
        return rng.integers(-32768, 32768, n, dtype=np.int16).tobytes()
    if width == 3:
        return rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32).tobytes()


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr,target", [(24000, None), (24000, 24000), (16000, 24000),
                                       (44100, 24000), (22050, None)])
def test_read_wav_bitwise(tmp_path, width, channels, sr, target):
    rng = np.random.default_rng(width * 10 + channels)
    path = tmp_path / "in.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(_pcm_bytes(rng, 1001 * channels, width))
    got, got_sr = P.read_wav(path, target_sr=target)
    want, want_sr = J.read_wav(path, target_sr=target)
    assert got_sr == want_sr and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_wav_refuses_what_jax_refuses(tmp_path):
    path = tmp_path / "bad.wav"
    with open(path, "wb") as f:
        f.write(b"not a wav")
    for mod in (P, J):
        with pytest.raises(Exception):
            mod.read_wav(path)


@pytest.mark.parametrize("sr_in,sr_out", [(24000, 24000), (16000, 24000), (48000, 24000),
                                          (44100, 24000), (8000, 22050)])
def test_resample_linear_bitwise(sr_in, sr_out):
    x = np.random.default_rng(sr_in).standard_normal(3333).astype(np.float32)
    got, want = P.resample_linear(x, sr_in, sr_out), J.resample_linear(x, sr_in, sr_out)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.1, 0.7, 1.0, 3.0])
def test_float_to_pcm16_and_write_wav_bitwise(tmp_path, scale):
    audio = (np.random.default_rng(int(scale * 10)).standard_normal(5000) * scale
             ).astype(np.float32)
    audio[:4] = [1.0, -1.0, 1.5, -7.0]            # the clip's edges and past them
    got, want = P.float_to_pcm16(audio), J.float_to_pcm16(audio)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    for sr in (24000, 16000):
        P.write_wav(tmp_path / "p.wav", audio, sr=sr)
        J.write_wav(tmp_path / "j.wav", audio, sr=sr)
        assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
        with wave.open(str(tmp_path / "p.wav"), "rb") as w:
            assert w.readframes(w.getnframes()) == got.tobytes()


@pytest.mark.parametrize("frames", [1, 7, 40])
def test_istft_same_matches_scipy(frames):
    import scipy.signal

    from mars5_tts_torch.models.vocos import istft_same

    n_fft, hop = 1280, 320
    rng = np.random.default_rng(frames)
    spec = (rng.standard_normal((1, n_fft // 2 + 1, frames))
            + 1j * rng.standard_normal((1, n_fft // 2 + 1, frames))).astype(np.complex64)
    window = np.hanning(n_fft + 1)[:-1]
    got = istft_same(torch.from_numpy(spec), n_fft, hop,
                     torch.from_numpy(window.astype(np.float32)))[0].numpy()
    with warnings.catch_warnings():
        # the periodic Hann window is 0 at sample 0, so scipy's NOLA check
        # warns about the first and last samples, which the crop drops
        warnings.simplefilter("ignore")
        _, ref = scipy.signal.istft(spec[0].astype(np.complex128) / window.sum(),
                                    window=window, nperseg=n_fft, noverlap=n_fft - hop,
                                    nfft=n_fft, input_onesided=True, boundary=False)
    pad = (n_fft - hop) // 2
    ref = ref[pad:len(ref) - pad]
    assert got.shape == ref.shape == ((frames - 1) * hop + n_fft - 2 * pad,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ISTFT_ATOL)
