"""High-frequency-component (HFC) extraction via an FFT band-stop filter
(counterpart of wildlifemapper_tpu/ops/hfc.py; reference network.py:36-57):
grayscale -> centred 2-D FFT (norm="forward") -> zero a central square of the
shifted spectrum -> inverse FFT -> |real part|.

Always float32. The "matmul" method computes `gray - low`, which cancels, so
its products must be full f32: TF32 is switched off around them.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# ITU-R 601 luma weights used by torchvision's Grayscale (network.py:41).
_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


def _line(h: int, w: int, rate: float) -> int:
    return int((w * h * rate) ** 0.5 // 2)


@functools.lru_cache(maxsize=8)
def _bandstop_mask_np(h: int, w: int, rate: float) -> np.ndarray:
    """Unshifted band-stop mask: the centred square of the shifted spectrum
    (network.py:43-45), ifftshift'ed once."""
    line = _line(h, w, rate)
    mask = np.ones((h, w), dtype=np.float32)
    mask[h // 2 - line:h // 2 + line, w // 2 - line:w // 2 + line] = 0.0
    return np.fft.ifftshift(mask)


@functools.lru_cache(maxsize=8)
def _bandstop_mask_rfft_np(h: int, w: int, rate: float) -> np.ndarray:
    """Hermitian-symmetrised half-plane mask: Re(ifft2(F*M)) equals
    irfft2(rfft2(x) * (M(k) + M(-k)) / 2) for real x."""
    m = _bandstop_mask_np(h, w, rate)
    m_neg = np.roll(np.flip(np.flip(m, 0), 1), (1, 1), axis=(0, 1))
    m_sym = 0.5 * (m + m_neg)
    return np.ascontiguousarray(m_sym[:, : w // 2 + 1]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _lowpass_matrices_np(h: int, w: int, rate: float):
    """The removed low band is separable: x_lp = A_h @ x @ A_w^T with
    A = IDFT . diag(b) . DFT per axis, so
    Re(A_h X A_w^T) = Rh X Rw^T - Ih X Iw^T for real X."""
    def one_axis(n: int, line: int):
        b_shift = np.zeros(n)
        b_shift[n // 2 - line:n // 2 + line] = 1.0
        b = np.fft.ifftshift(b_shift)
        a = np.fft.ifft(b[:, None] * np.fft.fft(np.eye(n), axis=0), axis=0)
        return (np.ascontiguousarray(a.real.astype(np.float32)),
                np.ascontiguousarray(a.imag.astype(np.float32)))

    line = _line(h, w, rate)
    rh, ih = one_axis(h, line)
    rw, iw = one_axis(w, line)
    return rh, ih, rw, iw


# The static tensors below are cached on their device: copying a host array
# in every forward would synchronise the stream. They are built outside
# inference mode so that a later autograd caller may use them.

@functools.lru_cache(maxsize=8)
def _lowpass_matrices(h: int, w: int, rate: float, device: torch.device):
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device)
                     for m in _lowpass_matrices_np(h, w, rate))


@functools.lru_cache(maxsize=8)
def _mask(h: int, w: int, rate: float, device: torch.device, rfft: bool):
    m = _bandstop_mask_rfft_np(h, w, rate) if rfft \
        else _bandstop_mask_np(h, w, rate)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)


@functools.lru_cache(maxsize=8)
def _gray_weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(_GRAY_WEIGHTS, dtype=dtype, device=device)


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def rgb_to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) with ITU-R 601 weights."""
    return torch.tensordot(images, _gray_weights(images.dtype, images.device),
                           dims=([-1], [0]))


def hfc_filter(images: torch.Tensor, rate: float = 0.125,
               method: str = "matmul") -> torch.Tensor:
    """(B, H, W, 3) normalised NHWC images -> (B, H, W, 1) HFC map in the
    input dtype. method: 'matmul' (separable filter, default), 'rfft' (real
    FFT) or 'fft' (complex FFT, the reference op for op)."""
    orig_dtype = images.dtype
    gray = rgb_to_grayscale(images.to(torch.float32))
    h, w = gray.shape[-2], gray.shape[-1]

    if method == "matmul":
        rh, ih, rw, iw = _lowpass_matrices(h, w, float(rate), gray.device)
        with _full_f32_matmul():
            low = (torch.matmul(torch.matmul(rh, gray), rw.T)
                   - torch.matmul(torch.matmul(ih, gray), iw.T))
        inv = gray - low
    elif method == "rfft":
        mask = _mask(h, w, float(rate), gray.device, True)
        spec = torch.fft.rfft2(gray, norm="forward") * mask
        inv = torch.fft.irfft2(spec, s=(h, w), norm="forward")
    elif method == "fft":
        mask = _mask(h, w, float(rate), gray.device, False)
        spec = torch.fft.fft2(gray, norm="forward") * mask
        inv = torch.fft.ifft2(spec, norm="forward").real
    else:
        raise ValueError(f"unknown hfc method {method!r}")
    return inv.abs()[..., None].to(orig_dtype)
