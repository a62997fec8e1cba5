"""Huber-prior MM memory-gradient solvers (the reference's semi-quadratic
legacy reconstructions).

Reference: `vox_reconstruction` / `lmm_reconstruction`
(/root/reference/surfh/ToolsDir/algorithms.py:27-106), which drive
`qmm.mmmg` on a quadratic data term plus Huber finite-difference priors.
Here the whole MM memory-gradient iteration runs on device as one
`lax.fori_loop`: each step builds the Geman–Reynolds half-quadratic majorant
at the current point and minimizes it exactly over span{−∇J, x − x_prev}
(a 2×2 solve), the subspace scheme of qmm's `mmmg`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cg import SolverResult

# Compiled dispatch-mode (init, step) programs keyed by operator identity —
# strong refs to the keyed callables keep the ids valid (cf. cg._LCG_CACHE).
_HUBER_CACHE: dict = {}


def huber_value(u, delta):
    a = jnp.abs(u)
    return jnp.where(a <= delta, 0.5 * u * u, delta * a - 0.5 * delta * delta)


def huber_grad(u, delta):
    return jnp.clip(u, -delta, delta)


def huber_weight(u, delta):
    """Geman–Reynolds weights φ'(u)/u ∈ (0, 1]."""
    a = jnp.abs(u)
    return jnp.where(a <= delta, 1.0, delta / jnp.maximum(a, 1e-30))


def diff_axis(x, axis: int):
    """Non-circular forward difference along `axis` (the reference's
    `aljabr.Diff`)."""
    n = x.shape[axis]
    return jax.lax.slice_in_dim(x, 1, n, axis=axis) - jax.lax.slice_in_dim(
        x, 0, n - 1, axis=axis
    )


def diff_axis_t(y, axis: int, n: int):
    """Exact adjoint of :func:`diff_axis`."""
    pads = [(0, 0)] * y.ndim
    pads[axis] = (1, 0)
    a = jnp.pad(y, pads)  # a_j = y_{j-1}
    pads[axis] = (0, 1)
    b = jnp.pad(y, pads)  # b_j = y_j
    return a - b


def mmmg_huber(
    data_fwd: Callable,
    data_adj: Callable,
    y,
    priors: Sequence[Tuple[Callable, Callable, float, float]],
    x0,
    max_iter: int = 500,
    loop: str = "graph",
):
    """MM memory-gradient for J(x) = ½‖Hx−y‖² + Σ_k µ_k Σ Huber_δk(D_k x).

    priors: sequence of (D_fwd, D_adj, delta, mu).
    The majorant at x uses Huber weights w = φ'(u)/u; subspace directions are
    d0 = −∇J and d1 = x − x_prev, with the step from the 2×2 majorant system.

    H·x and H·x_prev are carried across iterations (exact by linearity:
    H·x_new = H·x + s·h0 + t·h1 and h1 = H·x − H·x_prev), so each iteration
    costs ONE forward (h0 = H·d0) + one adjoint instead of three forwards.
    `loop="dispatch"` runs the iteration as Python-orchestrated per-step
    jitted programs (the flagship-scale mode — an in-graph loop threads
    every captured table through the carry with a private copy).
    """
    x0 = jnp.asarray(x0)
    y = jnp.asarray(y, x0.dtype)

    def grad_from(hx, x):
        g = data_adj(hx - y)
        for D, Dt, delta, mu in priors:
            g = g + mu * Dt(huber_grad(D(x), delta))
        return g

    def quad_entries(x, d0, h0, d1, h1):
        """Majorant Gram entries over {d0, d1}; data parts from the carried
        H-images."""
        a00 = jnp.vdot(h0, h0, precision="highest").real
        a01 = jnp.vdot(h0, h1, precision="highest").real
        a11 = jnp.vdot(h1, h1, precision="highest").real
        for D, Dt, delta, mu in priors:
            w = huber_weight(D(x), delta)
            dd0, dd1 = D(d0), D(d1)
            a00 = a00 + mu * jnp.vdot(w * dd0, dd0, precision="highest").real
            a01 = a01 + mu * jnp.vdot(w * dd0, dd1, precision="highest").real
            a11 = a11 + mu * jnp.vdot(w * dd1, dd1, precision="highest").real
        return a00, a01, a11

    def init(x0):
        hx0 = data_fwd(x0)
        g0 = grad_from(hx0, x0)
        h0 = data_fwd(-g0)
        # first step: steepest descent on the majorant
        a00, _, _ = quad_entries(x0, -g0, h0, -g0, h0)
        alpha = jnp.vdot(g0, g0, precision="highest").real / jnp.maximum(a00, 1e-30)
        x1 = x0 - alpha * g0
        # h0 = H·(−g0) and x1 = x0 + α·(−g0), so H·x1 = H·x0 + α·h0
        hx1 = hx0 + alpha * h0
        return x1, x0, hx1, hx0

    def step(x, x_prev, hx, hx_prev):
        g = grad_from(hx, x)
        d0 = -g
        h0 = data_fwd(d0)
        d1 = x - x_prev
        h1 = hx - hx_prev
        a00, a01, a11 = quad_entries(x, d0, h0, d1, h1)
        b0 = -jnp.vdot(g, d0, precision="highest").real
        b1 = -jnp.vdot(g, d1, precision="highest").real
        det = a00 * a11 - a01 * a01
        safe = jnp.abs(det) > 1e-30
        s = jnp.where(safe, (b0 * a11 - b1 * a01) / jnp.where(safe, det, 1.0), b0 / jnp.maximum(a00, 1e-30))
        t = jnp.where(safe, (b1 * a00 - b0 * a01) / jnp.where(safe, det, 1.0), 0.0)
        x_new = x + s * d0 + t * d1
        hx_new = hx + s * h0 + t * h1
        gnorm = jnp.linalg.norm(g.ravel())
        return x_new, x, hx_new, hx, gnorm

    if loop == "dispatch":
        # memoized per-operator compiled programs (re-tracing per call costs
        # more than the solve — same policy as _LCG_CACHE/_MMMG_CACHE)
        key = (
            id(data_fwd), id(data_adj),
            tuple((id(D), id(Dt), float(d), float(m)) for D, Dt, d, m in priors),
            x0.shape, str(x0.dtype),
        )
        if key in _HUBER_CACHE:
            init_jit, step_jit = _HUBER_CACHE[key][0]
        else:
            init_jit, step_jit = jax.jit(init), jax.jit(step)
            _HUBER_CACHE[key] = ((init_jit, step_jit), data_fwd, data_adj, priors)
        x, x_prev, hx, hx_prev = init_jit(x0)
        norms = []
        for _ in range(1, max_iter):
            x, x_prev, hx, hx_prev, gn = step_jit(x, x_prev, hx, hx_prev)
            norms.append(gn.astype(jnp.float32))
        # ONE stacked device fetch instead of a float() (and a device
        # synchronisation) per norm
        norms_np = np.asarray(jnp.stack(norms), np.float64)
        return SolverResult(
            x=np.asarray(x),
            grad_norm=norms_np,
            n_iter=max_iter,
            converged=True,
        )

    @jax.jit
    def run(x0):
        x1, xp, hx1, hxp = init(x0)
        norms = jnp.zeros((max_iter,), x0.dtype)

        def body(it, state):
            x, x_prev, hx, hx_prev, norms = state
            x_new, x, hx_new, hx, gnorm = step(x, x_prev, hx, hx_prev)
            norms = norms.at[it].set(gnorm)
            return x_new, x, hx_new, hx, norms

        x, x_prev, hx, hx_prev, norms = jax.lax.fori_loop(
            1, max_iter, body, (x1, xp, hx1, hxp, norms)
        )
        return x, norms

    x, norms = run(x0)
    return SolverResult(
        x=np.asarray(x),
        grad_norm=np.asarray(norms)[1:],
        n_iter=max_iter,
        converged=True,
    )


def vox_reconstruction(
    data,
    data_model,
    spat_reg: float = 1.0,
    spat_th: float = 1.0,
    spec_reg: float = 1.0,
    spec_th: float = 1.0,
    init=None,
    max_iter: int = 500,
    loop: str = "graph",
) -> SolverResult:
    """Voxel-cube reconstruction with Huber spatial-row/col + spectral priors
    (reference algorithms.vox_reconstruction, :27-71).  `data_model` maps a
    cube [λ, Nα, Nβ] to data; spatial diffs run over the sky axes and the
    spectral diff over λ."""
    ishape = data_model.ishape
    fwd, adj = data_model.forward, data_model.adjoint
    priors = [
        (lambda x: diff_axis(x, 1), lambda u: diff_axis_t(u, 1, ishape[1]), spat_th, spat_reg),
        (lambda x: diff_axis(x, 2), lambda u: diff_axis_t(u, 2, ishape[2]), spat_th, spat_reg),
        (lambda x: diff_axis(x, 0), lambda u: diff_axis_t(u, 0, ishape[0]), spec_th, spec_reg),
    ]
    if init is None:
        init = data_adj_init(data_model, data)
    return mmmg_huber(fwd, adj, data, priors, init, max_iter=max_iter, loop=loop)


def lmm_reconstruction(
    data,
    data_model,
    spat_reg: float = 1.0,
    spat_th: float = 1.0,
    init=None,
    max_iter: int = 500,
    loop: str = "graph",
) -> SolverResult:
    """Abundance-maps reconstruction with Huber spatial priors
    (reference algorithms.lmm_reconstruction, :74-106)."""
    ishape = data_model.ishape
    fwd, adj = data_model.forward, data_model.adjoint
    priors = [
        (lambda x: diff_axis(x, 1), lambda u: diff_axis_t(u, 1, ishape[1]), spat_th, spat_reg),
        (lambda x: diff_axis(x, 2), lambda u: diff_axis_t(u, 2, ishape[2]), spat_th, spat_reg),
    ]
    if init is None:
        init = data_adj_init(data_model, data)
    return mmmg_huber(fwd, adj, data, priors, init, max_iter=max_iter, loop=loop)


def data_adj_init(data_model, data):
    """Hᵗy warm start (the reference's `data_adeq.ht_data` default)."""
    return jnp.asarray(data_model.adjoint(data))
