"""Spectral blur (the R operator) as batched GEMM contractions.

The reference's hot kernel: out[λ', α, β] = Σ_λ arr[λ, α, β] · wpsf[λ', λ, β]
with OpenMP Cython / numba / JAX broadcast implementations
(`surfh/ToolsDir/cythons_files.pyx:202-319`, `surfh/ToolsDir/jax_utils.py:62-101`).

Accelerator mapping: for fixed β this is a (λ'×λ) @ (λ×α) matmul; the fused
"blur + β-sum" used on the detector path contracts jointly over (λ, β), i.e. a
single [λ', λ·β] @ [λ·β, α] matmul per slit.  The α-axis
subsampling of the detector model commutes with the blur (α is a bystander
axis), so callers subsample *before* blurring for an srf× saving.

A banded spelling exploiting the narrow sinc² support lives in
:mod:`surfh_tpu.core.wblur_banded` (the opt-in `wblur_impl="banded"`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .precision import gemm_precision


@jax.jit
def wblur(arr, wpsf):
    """[λ', α, β] = Σ_λ arr[λ, α, β] · wpsf[λ', λ, β]."""
    return jnp.einsum("lab,klb->kab", arr, wpsf,
                      preferred_element_type=arr.dtype,
                      precision=gemm_precision())


@jax.jit
def wblur_t(arr, wpsf):
    """Adjoint: [λ, α, β] = Σ_λ' arr[λ', α, β] · wpsf[λ', λ, β]."""
    return jnp.einsum("kab,klb->lab", arr, wpsf,
                      preferred_element_type=arr.dtype,
                      precision=gemm_precision())


@jax.jit
def wblur_sum_beta(arr, wpsf):
    """Fused blur + β-sum: [λ', α] = Σ_λ Σ_β arr[λ, α, β] · wpsf[λ', λ, β].

    Equivalent to the reference `wblur_subSampling`
    (/root/reference/surfh/ToolsDir/jax_utils.py:72-80).  Contracted as one
    matmul over the joint (λ, β) axis.
    """
    l, a, b = arr.shape
    k = wpsf.shape[0]
    lhs = wpsf.transpose(0, 1, 2).reshape(k, l * b)          # [λ', λ·β]
    rhs = arr.transpose(0, 2, 1).reshape(l * b, a)           # [λ·β, α]
    return jnp.matmul(lhs, rhs, preferred_element_type=arr.dtype,
                      precision=gemm_precision())


@jax.jit
def wblur_sum_beta_batched(arr, wpsf):
    """Batched over slits: [s, λ', α] = Σ_λβ arr[s, λ, α, β] · wpsf[λ', λ, β].

    Spelled as ONE plain GEMM [λ', λ·β] @ [λ·β, s·α] — NOT a batched-einsum
    over s: a batch dim makes XLA re-stream the wpsf table (K·W·β ≈ 26 MB at
    flagship scale) once per slit, turning a compute-trivial contraction
    memory-bound (S ≈ 12–21 redundant table reads)."""
    s, l, a, b = arr.shape
    k = wpsf.shape[0]
    lhs = wpsf.reshape(k, l * b)
    rhs = arr.transpose(1, 3, 0, 2).reshape(l * b, s * a)
    out = jnp.matmul(lhs, rhs, preferred_element_type=arr.dtype,
                     precision=gemm_precision())
    return out.reshape(k, s, a).transpose(1, 0, 2)


def wblur_sum_beta_pointings(arr, wpsf):
    """Pointing-batched twin of :func:`wblur_sum_beta_batched`:
    arr [λ, p, s, α, β] → [p, s, λ', α], still ONE plain GEMM — the pointing
    axis rides the GEMM's N dimension (P× larger tiles, one op instead of
    P; same contraction, though backend reduction blocking may differ at
    the ~1e-15 level from the per-pointing spelling)."""
    l, p, s, a, b = arr.shape
    k = wpsf.shape[0]
    lhs = wpsf.reshape(k, l * b)
    rhs = arr.transpose(0, 4, 1, 2, 3).reshape(l * b, p * s * a)
    out = jnp.matmul(lhs, rhs, preferred_element_type=arr.dtype,
                     precision=gemm_precision())
    return out.reshape(k, p, s, a).transpose(1, 2, 0, 3)


# Reference-name alias (jax_utils.wblur_subSampling, jax_utils.py:72-80).
wblur_subSampling = wblur_sum_beta
