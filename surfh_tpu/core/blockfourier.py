"""Block-Fourier Hessian algebra for decimated convolution operators.

A convolution followed by (di, dj) decimation has a Hessian HᵗH that is
block-diagonal in Fourier space: frequencies aliasing onto each other under
decimation couple in (di·dj)-sized blocks, and the LMM adds an n_spec-sized
template dimension, giving per-frequency blocks of size (n_spec·di·dj)².
This enables exact closed-form solves by inverting each block independently.

Reference: `partitioning_einops2` / `concat_M` / `concatenating2` / `split_M`
/ `make_iHtH_spectro` / `apply_hessian_freq`
(/root/reference/surfh/ToolsDir/algorithms.py:108-184).  The redesign
replaces the reference's per-frequency Python double loop in
`make_iHtH_spectro` with ONE batched `jnp.linalg.inv` over all frequencies
(the blocks stack into one [h·w, S·D, S·D] batch).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .precision import gemm_precision
import numpy as np


def dft2(x):
    """Unitary full-spectrum 2-D FFT over the last two axes."""
    return jnp.fft.fftn(x, axes=(-2, -1), norm="ortho")


def idft2(x):
    """Unitary full-spectrum 2-D inverse FFT over the last two axes."""
    return jnp.fft.ifftn(x, axes=(-2, -1), norm="ortho")


def partition(cubef, di: int, dj: int):
    """[λ, H, W] → [λ, di·dj, H/di, W/dj] decimation-block partition
    (reference partitioning_einops2, algorithms.py:108-112)."""
    wl, H, W = cubef.shape
    bx, by = H // di, W // dj
    return (
        cubef.reshape(wl, di, bx, dj, by)
        .transpose(0, 1, 3, 2, 4)
        .reshape(wl, di * dj, bx, by)
    )


def unpartition(part, shape_target: Tuple[int, int], di: int, dj: int):
    """Inverse of :func:`partition` (reference concatenating2)."""
    n, dd, bx, by = part.shape
    return (
        part.reshape(n, di, dj, bx, by)
        .transpose(0, 1, 3, 2, 4)
        .reshape(n, shape_target[0], shape_target[1])
    )


def make_iHtH(hess):
    """Per-frequency block inversion of a [S, S, D, D, h, w] block Hessian.

    One batched matrix inverse over all h·w frequencies (rows/cols ordered
    (spec, block) to match the reference's concat_M layout,
    algorithms.py:117-127)."""
    hess = jnp.asarray(hess)
    S, _, D, _, h, w = hess.shape
    M = hess.transpose(4, 5, 0, 2, 1, 3).reshape(h * w, S * D, S * D)
    iM = jnp.linalg.inv(M)
    return iM.reshape(h, w, S, D, S, D).transpose(2, 4, 3, 5, 0, 1)


def apply_hessian_freq(hess, di: int, dj: int, shape_target, x_freq):
    """Apply a block Hessian to partitioned full-spectrum maps
    (reference apply_hessian_freq, algorithms.py:170-184).

    x_freq: [S, H, W] full-spectrum maps; returns [S, H, W] full-spectrum.
    """
    part = partition(x_freq, di, dj)
    out = jnp.einsum("abijhw,bjhw->aihw", hess, part,
                     precision=gemm_precision())
    return unpartition(out, shape_target, di, dj)


def apply_hessian(hess, di: int, dj: int, shape_target, x):
    """Real-domain wrapper of :func:`apply_hessian_freq`
    (reference mixing.apply_hessian2, mixing.py:102-126)."""
    return jnp.real(idft2(apply_hessian_freq(hess, di, dj, shape_target, dft2(x))))
