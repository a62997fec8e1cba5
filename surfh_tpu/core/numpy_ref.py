"""NumPy/SciPy reference implementations: accuracy oracle and CPU baseline.

Two jobs:

1. **Accuracy oracle** — independent NumPy implementations of every kernel
   and of the full channel/spectro pipelines, for backend-equivalence tests
   (the role of the reference's `test/test_accel_accuracy.py`, which
   cross-checks its NumPy / JAX / Cython / numba kernel quadruplicates).

2. **Empirical CPU baseline** — the reference publishes no benchmark
   numbers (see BASELINE.md), so `bench.py` times this path to establish
   the reference-equivalent CPU cost.  It mirrors the reference execution
   structure (/root/reference/surfh/Models/spectroModelChannel.py:215-264):
   serial per-channel/per-pointing/per-slit loops, `scipy.fft` with
   `workers=-1` (the reference's fast FFT path, python_utils.py:55-56),
   gather-based bilinear regridding, dense einsum spectral blur.
"""

from __future__ import annotations

import numpy as np

try:  # the reference uses scipy.fft workers=-1; fall back to numpy.fft
    from scipy import fft as _sfft

    def _rfftn(a):
        return _sfft.rfftn(a, axes=(-2, -1), norm="ortho", workers=-1)

    def _irfftn(a, s):
        return _sfft.irfftn(a, s=s, axes=(-2, -1), norm="ortho", workers=-1)

except ImportError:  # pragma: no cover

    def _rfftn(a):
        return np.fft.rfftn(a, axes=(-2, -1), norm="ortho")

    def _irfftn(a, s):
        return np.fft.irfftn(a, s=s, axes=(-2, -1), norm="ortho")


# ---------------------------------------------------------------------------
# kernels
def dft(a):
    """Unitary rfft2 over the last two axes (reference jax_utils.dft:30-32)."""
    return _rfftn(a)


def idft(a, im_shape):
    """Unitary irfft2 (reference jax_utils.idft:39-41)."""
    return _irfftn(a, s=tuple(im_shape))


def lmm_maps2cube(maps, templates):
    """cube[λ,i,j] = Σ_m maps[m,i,j]·tpl[m,λ] (reference jax_utils.py:10-15)."""
    return np.tensordot(templates.T, maps, axes=1)


def lmm_cube2maps(cube, templates):
    """Adjoint LMM (reference jax_utils.py:17-26)."""
    return np.tensordot(templates, cube, axes=1)


def wblur(arr, wpsf):
    """out[k,a,b] = Σ_l arr[l,a,b]·wpsf[k,l,b] (reference jax_utils.wblur:62-70)."""
    return np.einsum("lab,klb->kab", arr, wpsf)


def wblur_t(arr, wpsf):
    """Adjoint: out[l,a,b] = Σ_k arr[k,a,b]·wpsf[k,l,b] (jax_utils.wblur_t:83-91)."""
    return np.einsum("kab,klb->lab", arr, wpsf)


def wblur_sum_beta(arr, wpsf):
    """out[k,a] = Σ_l Σ_b arr[l,a,b]·wpsf[k,l,b] (jax_utils.wblur_subSampling:72-80)."""
    return np.einsum("lab,klb->ka", arr, wpsf)


def wblur_sum_beta_t(y, wpsf, n_beta):
    """Adjoint of :func:`wblur_sum_beta`: out[l,a,b] = Σ_k y[k,a]·wpsf[k,l,b]."""
    return np.einsum("ka,klb->lab", y, wpsf)


def apply_plan(plan, cube):
    """NumPy twin of `core.bilinear.apply_plan`: 4-corner gather."""
    flat = cube.reshape(cube.shape[:-2] + (-1,))
    out = np.zeros(cube.shape[:-2] + (plan.npoints,), cube.dtype)
    for c in range(plan.idx.shape[0]):
        out += plan.w[c] * flat[..., plan.idx[c]]
    return out


def scatter_plan(plan, values, grid_shape):
    """Exact adjoint of :func:`apply_plan` (4-point scatter-add)."""
    na, nb = grid_shape
    flat = np.zeros(values.shape[:-1] + (na * nb,), values.dtype)
    for c in range(plan.idx.shape[0]):
        np.add.at(flat, (..., plan.idx[c]), plan.w[c] * values)
    return flat.reshape(values.shape[:-1] + (na, nb))


# ---------------------------------------------------------------------------
# channel pipeline (mirrors Channel._forward_windowed on CPU)
def channel_forward(chan, cube):
    """Reference-structured CPU forward of one channel over the full cube."""
    xw = np.asarray(cube)[chan.wslice]
    n_aout = chan.oshape[3]
    srf = chan.srf
    nla, nlb = chan.local_im_shape
    sb = chan.slit_shape[2]
    otf = np.asarray(chan.otf_combined)
    wpsf = chan.wpsf
    weights = np.asarray(chan.slit_weights_sub)
    out = np.zeros(chan.oshape)
    for p, plan in enumerate(chan.plans_fwd):
        gridded = apply_plan(plan, xw).reshape(xw.shape[0], nla, nlb)
        summed = idft(dft(gridded) * otf, (nla, nlb))
        for s, (a0, b0) in enumerate(zip(chan.slit_a_starts, chan.slit_b_starts)):
            win = summed[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
            win = win * weights[s][np.newaxis, :, :]
            out[p, s] = wblur_sum_beta(win, wpsf)
    return out


def channel_adjoint(chan, y):
    """Exact CPU transpose of :func:`channel_forward` → λ-window cube."""
    y = np.asarray(y).reshape(chan.oshape)
    n_aout = chan.oshape[3]
    srf = chan.srf
    nla, nlb = chan.local_im_shape
    W = chan.n_wslice
    sb = chan.slit_shape[2]
    otf_c = np.asarray(chan.otf_combined_conj)
    wpsf = chan.wpsf
    weights = np.asarray(chan.slit_weights_sub)
    imshape = chan.imshape
    out = np.zeros((W,) + imshape)
    for p, plan in enumerate(chan.plans_fwd):
        summed_t = np.zeros((W, nla, nlb))
        for s, (a0, b0) in enumerate(zip(chan.slit_a_starts, chan.slit_b_starts)):
            win_t = wblur_sum_beta_t(y[p, s], wpsf, sb) * weights[s][np.newaxis]
            summed_t[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb] += win_t
        gridded_t = idft(dft(summed_t) * otf_c, (nla, nlb))
        out += scatter_plan(plan, gridded_t.reshape(W, -1), imshape)
    return out


# ---------------------------------------------------------------------------
# flagship pipeline
def spectro_forward(model, x, sotf=None):
    """Reference-structured CPU forward of `SpectroSigRLSCT` (serial loops).

    `sotf` defaults to the model's materialized OTF; pass it for models
    built from PSF stamps (which hold none)."""
    x = np.asarray(x, np.float64).reshape(model.ishape)
    sotf = model.sotf if sotf is None else sotf
    if model.lmm:
        cube = lmm_maps2cube(x, model.templates)
    else:
        cube = x
    blurred = idft(dft(cube) * sotf, model.imshape)
    return np.concatenate(
        [channel_forward(chan, blurred).ravel() for chan in model.channels]
    )


def spectro_adjoint(model, y, sotf=None):
    """Exact CPU transpose of :func:`spectro_forward`."""
    y = np.asarray(y, np.float64).ravel()
    sotf = model.sotf if sotf is None else sotf
    cube = np.zeros(model.cube_shape)
    for c, chan in enumerate(model.channels):
        block = y[model._idx[c] : model._idx[c + 1]]
        cube[chan.wslice] += channel_adjoint(chan, block)
    blurred_t = idft(dft(cube) * np.conj(sotf), model.imshape)
    if model.lmm:
        return lmm_cube2maps(blurred_t, model.templates)
    return blurred_t
