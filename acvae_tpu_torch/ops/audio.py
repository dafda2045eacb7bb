"""Waveform -> log-mel frontend (counterpart of ``acvae_tpu/ops/audio.py:23-104``).

The PANN/librosa convention: sr 32 kHz, n_fft 1024, hop 320, 64
slaney-normalized mel bands, ``10·log10(max(S, amin)/ref)`` with an optional
``top_db`` floor.  The filterbank is built once per setting on the host
(numpy); the STFT and the projection run on the wave's device, in float64,
and the log-mel is returned in float32.  A float32 FFT's error is relative
to the frame's peak power, so in a band 60-80 dB below it two float32 FFT
libraries give dB values up to ~2.5e-3 apart (cuFFT and pocketfft on a
resampled clip; the JAX package's float32 frontend is up to 3.4e-4 dB off
a float64 pass there); in float64 the card and the CPU agree to ~1e-6 dB.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 50.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_fft//2+1, n_mels]
    (cached; read-only, since every caller shares it)."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    out = weights.T.astype(np.float32)
    out.setflags(write=False)
    return out


def stft_power(wave: torch.Tensor, n_fft: int = 1024, hop_length: int = 320,
               center: bool = True) -> torch.Tensor:
    """Power spectrogram [N, frames, n_fft//2+1] with a periodic Hann window,
    in float64."""
    wave = wave.double()
    if center:
        pad = n_fft // 2
        wave = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = wave.unfold(-1, n_fft, hop_length)          # [N, frames, n_fft]
    window = torch.tensor(np.hanning(n_fft + 1)[:-1].astype(np.float32),
                          dtype=torch.float64, device=wave.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return spec.abs() ** 2


def log_mel_spectrogram(wave: torch.Tensor, sr: int = 32000, n_fft: int = 1024,
                        hop_length: int = 320, n_mels: int = 64,
                        fmin: float = 50.0, fmax: Optional[float] = None,
                        amin: float = 1e-10, top_db: Optional[float] = None,
                        ref: float = 1.0) -> torch.Tensor:
    """wave [N, L] -> log-mel [N, frames, n_mels] float32."""
    power = stft_power(wave, n_fft, hop_length)
    fbank = torch.tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                         dtype=torch.float64, device=wave.device)
    log_mel = 10.0 * torch.log10(torch.clamp_min(power @ fbank, amin) / ref)
    if top_db is not None:
        log_mel = torch.maximum(
            log_mel, log_mel.amax(dim=(1, 2), keepdim=True) - top_db)
    return log_mel.float()
