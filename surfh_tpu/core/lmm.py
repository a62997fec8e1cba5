"""Linear mixing model (the T operator) as plain matmuls.

The reference implements maps→cube as a broadcast-sum
(`surfh/ToolsDir/jax_utils.py:10-26`, Cython twins
`surfh/ToolsDir/cythons_files.pyx:424-486`).  Here the same contraction is a
single GEMM [λ, m] @ [m, Nα·Nβ].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .precision import gemm_precision


@jax.jit
def lmm_maps2cube(maps, templates):
    """cube[λ, i, j] = Σ_m maps[m, i, j] · templates[m, λ].

    maps: [m, Nα, Nβ]; templates: [m, λ] → cube [λ, Nα, Nβ].
    """
    m, na, nb = maps.shape
    flat = maps.reshape(m, na * nb)
    cube = jnp.matmul(templates.T, flat, preferred_element_type=flat.dtype,
                      precision=gemm_precision())
    return cube.reshape(templates.shape[1], na, nb)


@jax.jit
def lmm_cube2maps(cube, templates):
    """maps[m, i, j] = Σ_λ cube[λ, i, j] · templates[m, λ] (exact adjoint)."""
    l, na, nb = cube.shape
    flat = cube.reshape(l, na * nb)
    maps = jnp.matmul(templates, flat, preferred_element_type=flat.dtype,
                      precision=gemm_precision())
    return maps.reshape(templates.shape[0], na, nb)
