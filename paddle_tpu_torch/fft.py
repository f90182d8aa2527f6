"""`paddle.fft`: the discrete Fourier transforms, on ``torch.fft``.

Counterpart: ``paddle_tpu/fft.py:1-120``: the same names, arguments and
norms (``"backward"``, ``"ortho"``, ``"forward"``). The N-D Hermitian
transforms are the reference's separable composition: the 1-D Hermitian
transform on the last axis and a complex FFT on the others, each with
its own norm factor. `fftfreq` and `rfftfreq` take ``dtype`` (float32
when None: the reference's x64 mode gives float64) and run on the
expected device.
"""
from __future__ import annotations

import torch

from . import device as _dev
from .core.dtype import convert_dtype

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fftn", "ifftn",
           "rfftn", "irfftn", "fft2", "ifft2", "rfft2", "irfft2", "hfft2",
           "ihfft2", "hfftn", "ihfftn", "fftshift", "ifftshift", "fftfreq",
           "rfftfreq"]


def _fft_op(name, tfn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return tfn(x, n=n, dim=axis, norm=norm)
    op.__name__ = op.__qualname__ = name
    return op


def _fftn_op(name, tfn):
    def op(x, s=None, axes=None, norm="backward", name=None):
        return tfn(x, s=s, dim=axes, norm=norm)
    op.__name__ = op.__qualname__ = name
    return op


fft = _fft_op("fft", torch.fft.fft)
ifft = _fft_op("ifft", torch.fft.ifft)
rfft = _fft_op("rfft", torch.fft.rfft)
irfft = _fft_op("irfft", torch.fft.irfft)
hfft = _fft_op("hfft", torch.fft.hfft)
ihfft = _fft_op("ihfft", torch.fft.ihfft)

fftn = _fftn_op("fftn", torch.fft.fftn)
ifftn = _fftn_op("ifftn", torch.fft.ifftn)
rfftn = _fftn_op("rfftn", torch.fft.rfftn)
irfftn = _fftn_op("irfftn", torch.fft.irfftn)


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.fft2(x, s=s, dim=axes, norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.ifft2(x, s=s, dim=axes, norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.rfft2(x, s=s, dim=axes, norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.irfft2(x, s=s, dim=axes, norm=norm)


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=axes)


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=axes)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return torch.fft.fftfreq(n, d=d, dtype=convert_dtype(dtype),
                             device=_dev.resolve_device(None))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return torch.fft.rfftfreq(n, d=d, dtype=convert_dtype(dtype),
                              device=_dev.resolve_device(None))


def _hfftn_impl(name, inverse):
    """The N-D Hermitian transform as the reference composes it: the 1-D
    one on the last axis of ``axes``, a complex FFT on the others."""
    def op(x, s=None, axes=None, norm="backward", name=None):
        ax = axes
        if ax is None:
            ax = list(range(x.ndim - len(s), x.ndim)) if s is not None \
                else list(range(x.ndim))
        ax = [a % x.ndim for a in ax]
        lead, last = ax[:-1], ax[-1]
        s_lead = None if s is None else list(s[:-1])
        n_last = None if s is None else s[-1]
        if inverse:
            out = torch.fft.ihfft(x, n=n_last, dim=last, norm=norm)
            if lead:
                out = torch.fft.ifftn(out, s=s_lead, dim=lead, norm=norm)
            return out
        out = torch.fft.fftn(x, s=s_lead, dim=lead, norm=norm) if lead else x
        return torch.fft.hfft(out, n=n_last, dim=last, norm=norm)
    op.__name__ = op.__qualname__ = name
    return op


hfftn = _hfftn_impl("hfftn", inverse=False)
ihfftn = _hfftn_impl("ihfftn", inverse=True)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return hfftn(x, s=s, axes=axes, norm=norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return ihfftn(x, s=s, axes=axes, norm=norm)
