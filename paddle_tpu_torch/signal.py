"""`paddle.signal`: `frame`, `overlap_add`, `stft`, `istft`.

Counterpart: ``paddle_tpu/signal.py:16-155``, with its signatures and
defaults (``center=True``, ``pad_mode="reflect"``, ``onesided=True``,
``normalized=False``) and its conventions: a real input's spectrum is
onesided (``n_fft // 2 + 1`` bins), frames come out ``[..., bins,
frames]``, `istft` divides by the summed squared window (the least-
squares inverse). Frames are gathered and overlap-added with index ops
(one ``index_add`` over all frames, where the reference adds them one
by one).
"""
from __future__ import annotations

import torch

from .ops import manip as _manip

__all__ = ["stft", "istft", "frame", "overlap_add"]


def _frame_index(n_frames, frame_length, hop_length, device):
    starts = torch.arange(n_frames, device=device) * hop_length
    return starts[:, None] + torch.arange(frame_length, device=device)[None]


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames of ``x`` along ``axis``: a 1-D input gives
    ``[num_frames, frame_length]`` for ``axis=0`` and ``[frame_length,
    num_frames]`` for ``axis=-1``."""
    ax = axis % x.ndim
    n_frames = 1 + (x.shape[ax] - frame_length) // hop_length
    idx = _frame_index(n_frames, frame_length, hop_length, x.device)
    out = torch.index_select(x, ax, idx.reshape(-1)).reshape(
        tuple(x.shape[:ax]) + (n_frames, frame_length)
        + tuple(x.shape[ax + 1:]))
    if axis != 0:
        out = out.swapaxes(-1, -2)
    return out


def _overlap(frames, hop_length):
    """``[N, F, L]`` frames added at hops into ``[N, (F - 1) * hop +
    L]``."""
    n, nf, fl = frames.shape
    out_len = (nf - 1) * hop_length + fl
    idx = _frame_index(nf, fl, hop_length, frames.device).reshape(-1)
    out = frames.new_zeros((n, out_len))
    return out.index_add(1, idx, frames.reshape(n, nf * fl))


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of `frame`: ``[..., frame_length, num_frames]``
    (``axis=-1``) or ``[num_frames, frame_length, ...]`` (``axis=0``)
    summed into the signal."""
    v = x
    if axis == 0:
        v = torch.movedim(torch.movedim(v, 0, -1), 0, -2)
    fl, nf = v.shape[-2], v.shape[-1]
    lead = tuple(v.shape[:-2])
    out = _overlap(v.reshape(-1, fl, nf).swapaxes(1, 2), hop_length)
    out = out.reshape(lead + (out.shape[-1],))
    if axis == 0:
        out = torch.movedim(out, -1, 0)
    return out


def _window(window, win_length, n_fft, device):
    win = window.float() if window is not None else torch.ones(
        win_length, dtype=torch.float32, device=device)
    pad = (n_fft - win_length) // 2
    return torch.nn.functional.pad(win, (pad, n_fft - win_length - pad))


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """The short-time Fourier transform: ``[..., n_fft // 2 + 1 (or
    n_fft), num_frames]`` complex."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, x.device)
    sig = x
    if center:
        p = n_fft // 2
        sig = _manip._pad_by_widths(sig, [(0, 0)] * (sig.ndim - 1)
                                    + [(p, p)], pad_mode)
    n_frames = 1 + (sig.shape[-1] - n_fft) // hop_length
    idx = _frame_index(n_frames, n_fft, hop_length, x.device)
    frames = sig[..., idx] * win
    spec = torch.fft.rfft(frames, dim=-1) if onesided \
        else torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / n_fft ** 0.5
    return spec.swapaxes(-1, -2)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse of `stft`, the frames divided by the summed squared
    window where they overlap."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, x.device)
    spec = x.swapaxes(-1, -2)
    if normalized:
        spec = spec * n_fft ** 0.5
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided \
        else torch.fft.ifft(spec, dim=-1).real
    frames = frames * win
    nf = frames.shape[-2]
    lead = tuple(frames.shape[:-2])
    out = _overlap(frames.reshape(-1, nf, n_fft), hop_length)
    den = _overlap((win * win).expand(1, nf, n_fft), hop_length)
    out = (out / den.clamp(min=1e-11)).reshape(lead + (out.shape[-1],))
    if center:
        p = n_fft // 2
        out = out[..., p:out.shape[-1] - p]
    if length is not None:
        out = out[..., :length]
    return out
