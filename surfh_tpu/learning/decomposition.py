"""On-device spectral template learning: NMF, PCA, N-FINDR + FCLS.

The reference learns its LMM templates offline in notebooks with sklearn
NMF/PCA and pysptools NFINDR+FCLS over masked reconstructed cubes
(/root/reference/notebooks/nmf_orion_allband.ipynb, pca_orion.ipynb,
nfinder_orion.ipynb), saving `templates.npy` / `wavel_axis.npy` consumed by
`scripts/main_fusion.py:77-101`.  Here the same decompositions run on device:

* NMF: Lee–Seung multiplicative updates as one `lax.fori_loop` (two
  matmuls per factor per iteration);
* PCA: SVD of the centered data matrix;
* N-FINDR: simplex-volume maximization by iterative vertex replacement;
* FCLS: batched projected-gradient nonnegative + sum-to-one least squares.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("n_components", "n_iter"))
def _nmf_run(X, W0, H0, n_components: int, n_iter: int):
    eps = jnp.asarray(1e-9, X.dtype)

    def body(_, WH):
        W, H = WH
        H = H * (W.T @ X) / (W.T @ W @ H + eps)
        W = W * (X @ H.T) / (W @ (H @ H.T) + eps)
        return W, H

    # full-f32 matmuls: reduced-precision (TF32/bf16) updates stall the
    # multiplicative descent near the fixed point (core/precision.py)
    with jax.default_matmul_precision("highest"):
        return jax.lax.fori_loop(0, n_iter, body, (W0, H0))


def nmf(
    X,
    n_components: int,
    n_iter: int = 500,
    seed: int = 0,
    dtype=jnp.float32,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Nonnegative factorization X ≈ W H (X: [n_samples, n_features] ≥ 0).

    Returns (W [n_samples, k], H [k, n_features], reconstruction_error) —
    the quantities the reference's NMF notebooks scan over k.
    """
    X = jnp.asarray(np.maximum(np.asarray(X), 0), dtype)
    rng = np.random.default_rng(seed)
    scale = float(np.sqrt(np.asarray(X).mean() / n_components + 1e-12))
    W0 = jnp.asarray(rng.random((X.shape[0], n_components)) * scale + 1e-3, dtype)
    H0 = jnp.asarray(rng.random((n_components, X.shape[1])) * scale + 1e-3, dtype)
    W, H = _nmf_run(X, W0, H0, n_components, n_iter)
    err = float(jnp.linalg.norm(X - W @ H))
    return np.asarray(W), np.asarray(H), err


def pca(X, n_components: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PCA of X [n_samples, n_features]: returns (components [k, f],
    explained_variance [k], scores [n, k])."""
    X = jnp.asarray(X)
    mean = jnp.mean(X, axis=0)
    Xc = X - mean
    U, S, Vt = jnp.linalg.svd(Xc, full_matrices=False)
    comps = Vt[:n_components]
    var = (S[:n_components] ** 2) / (X.shape[0] - 1)
    scores = U[:, :n_components] * S[:n_components]
    return np.asarray(comps), np.asarray(var), np.asarray(scores)


def nfindr(pixels: np.ndarray, n_endmembers: int, n_sweeps: int = 3, seed: int = 0):
    """N-FINDR endmember extraction: maximize the simplex volume spanned by
    `n_endmembers` pixel spectra in the (k−1)-dim PCA subspace.

    pixels: [n_pixels, n_bands].  Returns (endmembers [k, n_bands], indices).
    """
    pixels = np.asarray(pixels, np.float64)
    k = n_endmembers
    comps, _, scores = pca(pixels, k - 1)
    Y = np.asarray(scores)  # [n, k-1]
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(Y), size=k, replace=False)

    def volume(ind):
        M = np.ones((k, k))
        M[:, 1:] = Y[ind]
        return abs(np.linalg.det(M))

    best = volume(idx)
    for _ in range(n_sweeps):
        improved = False
        for j in range(k):
            trial = idx.copy()
            # vectorized scan over all candidate pixels for vertex j
            M = np.ones((k, k))
            M[:, 1:] = Y[idx]
            vols = np.empty(len(Y))
            for cand_block in np.array_split(np.arange(len(Y)), max(1, len(Y) // 4096)):
                Mb = np.broadcast_to(M, (len(cand_block), k, k)).copy()
                Mb[:, j, 1:] = Y[cand_block]
                vols[cand_block] = np.abs(np.linalg.det(Mb))
            cand = int(np.argmax(vols))
            if vols[cand] > best:
                idx[j] = cand
                best = vols[cand]
                improved = True
        if not improved:
            break
    return pixels[idx], idx


@partial(jax.jit, static_argnames=("n_iter",))
def _fcls_run(E, X, n_iter: int):
    k = E.shape[0]
    with jax.default_matmul_precision("highest"):
        G = E @ E.T  # [k, k]
        lip = jnp.linalg.norm(G, ord=2)
        B = E @ X.T  # [k, n]
    A = jnp.full((k, X.shape[0]), 1.0 / k, X.dtype)

    def project_simplex(a):
        """Euclidean projection of each column onto the probability simplex."""
        u = jnp.sort(a, axis=0)[::-1]
        css = jnp.cumsum(u, axis=0) - 1.0
        ks = jnp.arange(1, k + 1, dtype=a.dtype)[:, None]
        cond = u - css / ks > 0
        rho = jnp.sum(cond, axis=0)
        theta = jnp.take_along_axis(css, (rho - 1)[None, :], axis=0)[0] / rho.astype(a.dtype)
        return jnp.maximum(a - theta[None, :], 0.0)

    def body(_, A):
        grad = G @ A - B
        return project_simplex(A - grad / lip)

    with jax.default_matmul_precision("highest"):
        return jax.lax.fori_loop(0, n_iter, body, A)


def fcls(pixels, endmembers, n_iter: int = 200) -> np.ndarray:
    """Fully-constrained least squares unmixing: abundances ≥ 0, Σ = 1.

    pixels [n, bands], endmembers [k, bands] → abundances [n, k].
    Projected gradient with exact simplex projection (replaces pysptools
    FCLS)."""
    E = jnp.asarray(endmembers, jnp.float32)
    X = jnp.asarray(pixels, jnp.float32)
    A = _fcls_run(E, X, n_iter)
    return np.asarray(A.T)


def learn_templates_nmf(
    cube: np.ndarray,
    n_templates: int,
    mask: Optional[np.ndarray] = None,
    n_iter: int = 500,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Learn LMM spectral templates from a reconstructed cube [λ, Nα, Nβ]
    (the reference's notebook pipeline).  Returns (templates [k, λ],
    abundance maps [k, Nα, Nβ], reconstruction error)."""
    cube = np.asarray(cube)
    L = cube.shape[0]
    flat = cube.reshape(L, -1).T  # [pixels, λ]
    if mask is not None:
        sel = np.asarray(mask).ravel()
        X = flat[sel]
    else:
        sel = None
        X = flat
    W, H, err = nmf(X, n_templates, n_iter=n_iter, seed=seed)
    templates = H  # [k, λ]
    if sel is not None:
        maps_flat = np.zeros((flat.shape[0], n_templates))
        maps_flat[sel] = W
    else:
        maps_flat = W
    maps = maps_flat.T.reshape((n_templates,) + cube.shape[1:])
    return templates, maps, err
