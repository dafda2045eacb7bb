"""Port parity: ``cli prepare_data`` of ``acvae_tpu_torch`` (wavs ->
log-mels in ``.npz`` + the TSV manifest) against ``acvae_tpu``'s (HDF5),
on seeded wavs the test writes: int16 mono and stereo at 32 kHz, int16 at
16 kHz (resampled), float32 mono.

The port's frontend computes in float64 and returns float32; the JAX
package's computes in float32.  Both are held against the same clips'
log-mels computed in float64 with numpy: the port at atol 1e-5 dB
everywhere, and the port against JAX at atol 1e-4 dB (the tolerance of
``tests/test_torch_serve.py::test_log_mel_matches_jax``) except where JAX's
float32 FFT is itself off the float64 value (see below)."""
import h5py
import numpy as np
import pytest
from scipy.io import wavfile

from acvae_tpu.cli.main import Runner
from acvae_tpu.ops.audio import mel_filterbank
from acvae_tpu_torch.cli.main import _feature_source, main
from acvae_tpu_torch.data.dataset import CaptionDataset, CaptionLoader
from acvae_tpu_torch.data.vocab import Vocabulary
from tests.test_torch_decode import one_torch_thread  # noqa: F401

# name -> (rate, seconds, channels, dtype)
WAVS = {"mono.wav": (32000, 0.5, 1, np.int16),
        "stereo.wav": (32000, 0.7, 2, np.int16),
        "rate16k.wav": (16000, 0.6, 1, np.int16),
        "float.wav": (32000, 0.45, 1, np.float32)}


def float64_log_mel(path, sr=32000, n_fft=1024, hop=320):
    """The clip's log-mel in float64 (numpy's FFT), from the float32 wave
    both packages make of the file (``acvae_tpu/cli/main.py:2006-2018``)."""
    file_sr, data = wavfile.read(str(path))
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    if data.ndim > 1:
        data = data.mean(axis=1)
    if file_sr != sr:
        data = np.interp(np.linspace(0, len(data) - 1, int(len(data) / file_sr * sr)),
                         np.arange(len(data)), data)
    n = 1 + len(data) // hop
    wave = np.pad(data.astype(np.float32), (0, (-len(data)) % hop))
    wave = np.pad(wave.astype(np.float64), n_fft // 2, mode="reflect")
    frames = np.stack([wave[i * hop:i * hop + n_fft]
                       for i in range(1 + (len(wave) - n_fft) // hop)])
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    power = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    fbank = mel_filterbank(sr, n_fft, 64, 50.0, None).astype(np.float64)
    return 10 * np.log10(np.maximum(power @ fbank, 1e-10))[:n]


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("prepare_data")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    for i, (name, (sr, dur, ch, dt)) in enumerate(WAVS.items()):
        t = np.arange(int(sr * dur)) / sr
        wave = (0.4 * np.sin(2 * np.pi * (300 + 200 * i) * t)[:, None]
                + 0.05 * rng.normal(size=(len(t), ch)))
        data = (wave * 32767).astype(dt) if dt == np.int16 else wave.astype(dt)
        wavfile.write(str(wav_dir / name), sr, data[:, 0] if ch == 1 else data)
    csv = main(["prepare_data", str(wav_dir), str(root / "mels.npz"),
                str(root / "mels.csv"), "--device=cpu"])
    Runner().prepare_data(str(wav_dir), str(root / "mels.h5"),
                          str(root / "jax.csv"))
    return root, csv


def test_prepare_data_matches_jax(prepared):
    root, _ = prepared
    ours = np.load(root / "mels.npz")
    with h5py.File(root / "mels.h5") as ref:
        assert sorted(ours.files) == sorted(ref.keys()) == sorted(WAVS)
        for name, (sr, dur, _, _) in WAVS.items():
            mel, want = ours[name], ref[name][()]
            assert mel.dtype == np.float32 and mel.shape == want.shape
            # 1 + len // hop frames at 32 kHz, hop 320
            assert mel.shape == (1 + int(int(sr * dur) / sr * 32000) // 320, 64)
            exact = float64_log_mel(root / "wavs" / name)
            np.testing.assert_allclose(mel, exact, rtol=0, atol=1e-5,
                                       err_msg=name)
            # a band more than 60 dB below its frame's peak sits at the
            # float32 FFT's noise floor: there JAX's frontend is up to
            # 3.8e-4 dB off the float64 value (the resampled clip's two
            # top bands, 63-80 dB down), and the port is held to JAX
            # within 1e-4 dB beyond JAX's own error
            floor = exact < exact.max(axis=1, keepdims=True) - 60.0
            np.testing.assert_allclose(mel[~floor], want[~floor], rtol=0,
                                       atol=1e-4, err_msg=name)
            gap, jax_err = np.abs(mel - want)[floor], np.abs(want - exact)[floor]
            assert (gap <= 1e-4 + jax_err).all(), (name, gap.max())


def test_loader_reads_the_manifest(prepared):
    """The manifest is the TSV ``make_synthetic`` writes: the port's
    ``CaptionDataset`` and ``CaptionLoader`` read the clips from it."""
    root, csv = prepared
    lines = open(csv).read().splitlines()
    assert lines[0] == "audio_id\thdf5_path"
    assert sorted(line.split("\t")[0] for line in lines[1:]) == sorted(WAVS)
    info = [{"audio_id": name, "captions": [{"caption": "a tone",
                                             "tokens": "a tone"}]}
            for name in sorted(WAVS)]
    vocab = Vocabulary()
    for w in ("a", "tone"):
        vocab.add_word(w)
    ds = CaptionDataset(**_feature_source(csv), caption_info=info,
                        vocabulary=vocab)
    assert ds.data_dim == 64
    ours = np.load(root / "mels.npz")
    for i in range(len(ds)):
        aid, feat, cap, _ = ds.get(i)
        np.testing.assert_array_equal(feat, ours[aid])
        assert cap.tolist() == [1, 4, 5, 2]
    batch = next(iter(CaptionLoader(ds, batch_size=4)))
    assert sorted(batch.feat_lens.tolist()) == sorted(
        ours[n].shape[0] for n in WAVS)
    with pytest.raises(ValueError, match=".npz"):
        main(["prepare_data", str(root / "wavs"), str(root / "mels.h5"),
              str(root / "x.csv"), "--device=cpu"])
