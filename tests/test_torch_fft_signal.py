"""The port's `fft` and `signal` against paddle_tpu's ``fft.py`` and
``signal.py``: every public function on the same seeded numpy inputs,
each norm, the N-D Hermitian transforms as the reference composes them,
``stft``/``istft`` with the reference's defaults (``center=True``,
``pad_mode="reflect"``, ``onesided=True``, ``normalized=False``) and
round trips; dtypes and values within rtol 1e-4, atol 1e-4 (the FFT
libraries sum in other orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fft as jfft
import paddle_tpu.signal as jsignal
import paddle_tpu_torch as pt
from _torch_ops import Raw, check, on_cpu, rand  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
REAL = rand((3, 8), 1)
CPLX = rand((3, 8), 2, "complex64")
NORMS = ("backward", "ortho", "forward")

#: (name, args, kwargs)
FFT_CASES = [
    ("fft", [CPLX], {}), ("fft", [REAL], {"n": 6, "axis": 0}),
    ("ifft", [CPLX], {}), ("rfft", [REAL], {}),
    ("rfft", [REAL], {"n": 10}), ("irfft", [CPLX], {}),
    ("irfft", [CPLX], {"n": 9, "axis": 0}), ("hfft", [CPLX], {}),
    ("ihfft", [REAL], {}), ("fftn", [CPLX], {}),
    ("fftn", [rand((2, 3, 4), 3)], {"s": [4, 4], "axes": [0, 2]}),
    ("ifftn", [CPLX], {}), ("rfftn", [rand((2, 4, 6), 4)], {}),
    ("irfftn", [rand((2, 4, 5), 5, "complex64")], {}),
    ("irfftn", [rand((2, 4, 5), 5, "complex64")], {"s": [4, 8]}),
    ("fft2", [CPLX], {}), ("ifft2", [CPLX], {}), ("rfft2", [REAL], {}),
    ("irfft2", [CPLX], {}), ("hfft2", [CPLX], {}),
    ("hfft2", [rand((2, 4, 5), 6, "complex64")], {"s": [4, 8]}),
    ("ihfft2", [REAL], {}), ("hfftn", [rand((2, 4, 5), 7, "complex64")], {}),
    ("hfftn", [rand((2, 4, 5), 7, "complex64")], {"axes": [0, 2]}),
    ("ihfftn", [rand((2, 4, 6), 8)], {}),
    ("fftshift", [REAL], {}), ("fftshift", [REAL], {"axes": [1]}),
    ("ifftshift", [REAL], {}),
]


@pytest.mark.parametrize("case", FFT_CASES, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(FFT_CASES)])
def test_fft(case):
    name, args, kw = case
    norms = NORMS if name not in ("fftshift", "ifftshift") else (None,)
    for norm in norms:
        k = dict(kw, norm=norm) if norm else kw
        check(name, args, k, tol=TOL, ref_mod=jfft, port_mod=pt.fft)


@pytest.mark.parametrize("name", ["rfft", "fft2", "hfft", "ihfftn"])
def test_fft_grads_of_a_real_input(name):
    """The grads of ``sum(|y|^2)`` w.r.t. a real input, through each
    package's autograd."""
    x = rand((4, 6), 14)
    jx = paddle_tpu.to_tensor(x, stop_gradient=False)
    px = torch.from_numpy(x.copy()).requires_grad_(True)
    (getattr(jfft, name)(jx).abs() ** 2).sum().backward()
    (getattr(pt.fft, name)(px).abs() ** 2).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad._value),
                               **TOL)


@pytest.mark.parametrize("name", ["fftfreq", "rfftfreq"])
def test_fftfreq(name, on_cpu):
    """Values as the reference's; float32 by default (the reference's
    x64 mode gives float64, ROADMAP C.3), ``dtype`` honoured."""
    for n, d in ((8, 1.0), (7, 0.5)):
        r, p = check(name, [Raw(n)], {"d": d}, tol=TOL, ref_mod=jfft,
                     port_mod=pt.fft, dtypes=False)
        assert p.dtype == torch.float32
        assert getattr(pt.fft, name)(n, dtype="float64").dtype == \
            torch.float64


SIG = rand((2, 64), 9)


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_and_overlap_add(axis):
    x = SIG[0].copy() if axis == 0 else SIG
    check("frame", [x, Raw(16), Raw(8)], {"axis": axis}, tol=TOL,
          ref_mod=jsignal, port_mod=pt.signal, grad=True)
    frames = rand((5, 16), 10) if axis == 0 else rand((2, 16, 5), 10)
    check("overlap_add", [frames, Raw(8)], {"axis": axis}, tol=TOL,
          ref_mod=jsignal, port_mod=pt.signal, grad=True)
    check("frame", [rand((2, 40, 3), 11), Raw(8), Raw(4)], {"axis": 1},
          tol=TOL, ref_mod=jsignal, port_mod=pt.signal)


@pytest.mark.parametrize("kw", [
    {}, {"hop_length": 8, "win_length": 24},
    {"center": False, "normalized": True},
    {"pad_mode": "constant", "onesided": False},
], ids=["defaults", "hop-win", "uncentered-normalized", "constant-twosided"])
def test_stft(kw):
    win = np.hanning(kw.get("win_length", 32)).astype("float32")
    args = [SIG, Raw(32)]
    check("stft", args, kw, tol=TOL, ref_mod=jsignal, port_mod=pt.signal)
    check("stft", args + [], dict(kw, window=None), tol=TOL,
          ref_mod=jsignal, port_mod=pt.signal)
    r, p = check("stft", [SIG, Raw(32), Raw(kw.get("hop_length")),
                          Raw(kw.get("win_length")), win],
                 {k: v for k, v in kw.items()
                  if k not in ("hop_length", "win_length")},
                 tol=TOL, ref_mod=jsignal, port_mod=pt.signal)
    assert p.is_complex()


def test_istft_round_trip_and_against_the_reference():
    win = np.hanning(32).astype("float32") + 0.1
    spec = pt.signal.stft(torch.from_numpy(SIG), 32,
                          window=torch.from_numpy(win))
    back = pt.signal.istft(spec, 32, window=torch.from_numpy(win),
                           length=64)
    np.testing.assert_allclose(back.numpy(), SIG, **TOL)
    z = rand((2, 17, 9), 12, "complex64")
    for kw in ({}, {"normalized": True}, {"length": 40}, {"center": False}):
        check("istft", [z, Raw(32), Raw(None), Raw(None), win], kw, tol=TOL,
              ref_mod=jsignal, port_mod=pt.signal)
    check("istft", [rand((2, 32, 9), 13, "complex64"), Raw(32)],
          {"onesided": False}, tol=TOL, ref_mod=jsignal, port_mod=pt.signal)


def test_every_name_has_a_case():
    covered = {c[0] for c in FFT_CASES} | {"fftfreq", "rfftfreq"}
    assert set(jfft.__all__) == covered
    assert sorted(pt.fft.__all__) == sorted(jfft.__all__)
    assert sorted(pt.signal.__all__) == sorted(jsignal.__all__)
