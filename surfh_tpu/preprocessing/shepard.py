"""Exponential modified-Shepard scattered-data interpolation, on device.

Replaces the reference's Cython kernel
(/root/reference/surfh/ToolsDir/shepard_interpolation.pyx:76-141), which is a
serial O(grid × points) double loop.  Here the whole weight matrix is one
vectorized masked computation, evaluated in row chunks via `lax.map` to bound
memory — the natural accelerator shape for a dense scattered→grid
interpolation.
"""

from __future__ import annotations

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_LIB = None
_NATIVE_FAILED_MTIME = None


def _native_lib():
    """Load the optional OpenMP C++ kernel (native/libsurfh_native.so).

    Successful loads are cached; a miss is re-checked on every call (an
    `os.path.exists` — cheap) so a library built after first use (e.g. by
    the test fixture, or `make -C native` mid-session) is picked up.
    A .so that exists but fails to load (corrupt build, missing symbol)
    returns None so backend='auto' falls back to the JAX path; the failure
    is cached by mtime so a rebuilt library is retried.
    """
    global _NATIVE_LIB, _NATIVE_FAILED_MTIME
    if _NATIVE_LIB is not None:
        return _NATIVE_LIB
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libsurfh_native.so",
    )
    if os.path.exists(path):
        try:
            mtime = os.path.getmtime(path)
            if mtime == _NATIVE_FAILED_MTIME:
                return None
            lib = ctypes.CDLL(path)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.exponential_modified_shepard.argtypes = [
                f32p, f32p, f32p, ctypes.c_int64,
                f32p, f32p, ctypes.c_int64,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                f32p,
            ]
            lib.exponential_modified_shepard.restype = None
            _NATIVE_LIB = lib
        except (OSError, AttributeError):  # load failure / missing symbol
            _NATIVE_FAILED_MTIME = mtime
            return None
    return _NATIVE_LIB


def _shepard_native(
    pa, pl, vals, am, lm, p, alpha, pixel_cutoff, alpha_res, lambda_res, epsilon
):
    lib = _native_lib()
    pa = np.ascontiguousarray(pa, np.float32)
    pl = np.ascontiguousarray(pl, np.float32)
    vals = np.ascontiguousarray(vals, np.float32)
    ga = np.ascontiguousarray(am, np.float32).ravel()
    gl = np.ascontiguousarray(lm, np.float32).ravel()
    out = np.zeros(ga.size, np.float32)
    c = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.exponential_modified_shepard(
        c(pa), c(pl), c(vals), pa.size,
        c(ga), c(gl), ga.size,
        p, alpha, pixel_cutoff, alpha_res, lambda_res, epsilon,
        c(out),
    )
    return out.reshape(np.shape(am))


def exponential_modified_shepard(
    alpha_coord,
    lambda_coord,
    values,
    alpha_mesh,
    lambda_mesh,
    p: float = 2.0,
    alpha: float = 2.0,
    pixel_cutoff: float = 1.0,
    alpha_res: float = 1.0,
    lambda_res: float = 1.0,
    epsilon: float = 1e-6,
    row_chunk: int = 64,
    backend: str = "auto",
):
    """Interpolate scattered (α, λ, value) samples onto a regular mesh.

    Matches the reference semantics: pixel-unit distances (axes scaled by
    their resolutions), weights exp(−alpha·dist^p) for dist ≤ pixel_cutoff,
    zero where no point is in range.  Returns an array shaped like the mesh.

    backend: "jax" (device), "native" (OpenMP C++ from native/), or "auto"
    (native when built and no accelerator is present, else jax).
    """
    if backend not in ("auto", "jax", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    use_native = backend == "native" or (
        backend == "auto"
        and _native_lib() is not None
        and jax.default_backend() == "cpu"
    )
    if use_native:
        if _native_lib() is None:
            raise RuntimeError("native backend requested but native/libsurfh_native.so not built (make -C native)")
        return _shepard_native(
            alpha_coord, lambda_coord, values, alpha_mesh, lambda_mesh,
            p, alpha, pixel_cutoff, alpha_res, lambda_res, epsilon,
        )
    pa = jnp.asarray(alpha_coord, jnp.float32)
    pl = jnp.asarray(lambda_coord, jnp.float32)
    vals = jnp.asarray(values, jnp.float32)
    am = jnp.asarray(alpha_mesh, jnp.float32)
    lm = jnp.asarray(lambda_mesh, jnp.float32)
    inv_ar = jnp.float32(1.0 / alpha_res)
    inv_lr = jnp.float32(1.0 / lambda_res)

    shape = am.shape
    ga = am.ravel()
    gl = lm.ravel()
    # pad the grid to a chunk multiple
    n = ga.size
    n_pad = (-n) % row_chunk
    ga = jnp.pad(ga, (0, n_pad))
    gl = jnp.pad(gl, (0, n_pad))
    ga = ga.reshape(-1, row_chunk)
    gl = gl.reshape(-1, row_chunk)

    def chunk(args):
        ca, cl = args  # [row_chunk]
        da = (pa[jnp.newaxis, :] - ca[:, jnp.newaxis]) * inv_ar
        dl = (pl[jnp.newaxis, :] - cl[:, jnp.newaxis]) * inv_lr
        dist = jnp.sqrt(da * da + dl * dl) + jnp.float32(epsilon)
        w = jnp.where(
            dist <= pixel_cutoff, jnp.exp(-alpha * dist**p), 0.0
        )
        num = jnp.matmul(w, vals, precision="highest")
        den = jnp.sum(w, axis=1)
        return jnp.where(den != 0, num / jnp.where(den != 0, den, 1.0), 0.0)

    out = jax.lax.map(chunk, (ga, gl))
    return np.asarray(out.ravel()[:n].reshape(shape))
