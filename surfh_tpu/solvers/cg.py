"""On-device quadratic solvers: linear conjugate gradient and MM memory gradient.

Self-contained replacement for the slivers of the `qmm` package the reference
drives (`qmm.lcg` / `qmm.mmmg`, called from
/root/reference/surfh/Simulation/fusion_CT.py:194-232).  The whole solver
state lives in device memory; one jitted `lax.while_loop` per solve — no host↔device
round-trips inside the iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class SolverResult:
    """Mirror of the qmm OptimizeResult fields the reference consumes."""

    x: np.ndarray
    grad_norm: np.ndarray  # per-iteration gradient norms
    n_iter: int
    converged: bool
    crit_val: Optional[np.ndarray] = None  # per-iteration criterion (optional)
    state: Optional[tuple] = None  # full solver state (x, r, z, p, rz) for exact resume


def _as_tuple(x):
    return x if isinstance(x, (tuple, list)) else (x,)


# Compiled-solver cache: re-tracing and recompiling the jitted loop on every
# solve call can cost more than the solve itself at flagship scale.  Keyed by
# operator identity + static loop parameters; tol is a runtime argument so
# changing it never retraces.
_LCG_CACHE: dict = {}
_MMMG_CACHE: dict = {}


def _lcg_compiled(normal_op, M, max_iter, shape, dtype_str, fresh: bool, n_args: int):
    key = (id(normal_op), id(M), max_iter, shape, dtype_str, fresh, n_args)
    if key in _LCG_CACHE:
        return _LCG_CACHE[key][0]

    prec = M if M is not None else (lambda r: r)

    @jax.jit
    def run(init, b, tol, *op_args):
        if fresh:  # init is x0
            x0 = init
            r0 = b - normal_op(x0, *op_args)
            z0 = prec(r0)
            p0 = z0
            rz0 = jnp.vdot(r0, z0, precision="highest").real
        else:  # init is a full CG state (exact resume, conjugacy preserved)
            x0, r0, z0, p0, rz0 = init
        gnorm0 = jnp.linalg.norm(r0.ravel())
        bnorm = jnp.linalg.norm(b.ravel())
        norms = jnp.zeros((max_iter,), x0.dtype)

        def cond(state):
            x, r, z, p, rz, it, norms = state
            return jnp.logical_and(
                it < max_iter, jnp.linalg.norm(r.ravel()) > tol * bnorm
            )

        def body(state):
            x, r, z, p, rz, it, norms = state
            qp = normal_op(p, *op_args)
            alpha = rz / jnp.vdot(p, qp, precision="highest").real
            x = x + alpha * p
            r = r - alpha * qp
            z = prec(r)
            rz_new = jnp.vdot(r, z, precision="highest").real
            beta = rz_new / rz
            p = z + beta * p
            norms = norms.at[it].set(jnp.linalg.norm(r.ravel()))
            return x, r, z, p, rz_new, it + 1, norms

        state = (x0, r0, z0, p0, rz0, jnp.asarray(0), norms)
        x, r, z, p, rz, it, norms = jax.lax.while_loop(cond, body, state)
        return x, norms, it, gnorm0, (x, r, z, p, rz)

    # hold strong refs to the keyed callables so ids stay valid
    _LCG_CACHE[key] = (run, normal_op, M)
    return run


def _lcg_step_compiled(normal_op, M, shape, dtype_str, n_args, chain_steps=1):
    """`chain_steps` CG iterations as ONE standalone jitted program (dispatch
    mode).  Chaining K iterations per dispatch amortizes the per-dispatch
    host latency without an in-graph loop — the K step bodies are unrolled
    calls sharing the table arguments, so XLA does NOT thread private table
    copies through a while carry (the memory failure mode of
    `lax.while_loop` at flagship scale).  Returns a [K] vector of
    per-iteration residual norms."""
    key = ("step", id(normal_op), id(M), shape, dtype_str, n_args, chain_steps)
    if key in _LCG_CACHE:
        return _LCG_CACHE[key][0]

    prec = M if M is not None else (lambda r: r)

    def one_step(x, r, z, p, rz, *op_args):
        qp = normal_op(p, *op_args)
        alpha = rz / jnp.vdot(p, qp, precision="highest").real
        x = x + alpha * p
        r = r - alpha * qp
        z = prec(r)
        rz_new = jnp.vdot(r, z, precision="highest").real
        beta = rz_new / rz
        p = z + beta * p
        rnorm = jnp.linalg.norm(r.ravel()).astype(jnp.float32)
        return x, r, z, p, rz_new, rnorm

    @jax.jit
    def step(x, r, z, p, rz, *op_args):
        rnorms = []
        for _ in range(chain_steps):
            x, r, z, p, rz, rnorm = one_step(x, r, z, p, rz, *op_args)
            rnorms.append(rnorm)
        return x, r, z, p, rz, jnp.stack(rnorms)

    @jax.jit
    def init_state(x0, b, *op_args):
        r0 = b - normal_op(x0, *op_args)
        z0 = prec(r0)
        rz0 = jnp.vdot(r0, z0, precision="highest").real
        return (
            x0, r0, z0, z0, rz0,
            jnp.linalg.norm(r0.ravel()).astype(jnp.float32),
            jnp.linalg.norm(b.ravel()).astype(jnp.float32),
        )

    _LCG_CACHE[key] = ((step, init_state), normal_op, M)
    return step, init_state


def _lcg_dispatch(
    normal_op, b, x0, max_iter, tol, M, state, op_args, check_every: int = 25,
    chain_steps: int = 1,
):
    """CG as a Python-orchestrated chain of per-iteration dispatches.

    Same math as the `lax.while_loop` build, but the loop stays OUT of the
    graph: at flagship scale XLA threads every captured table through the
    while-loop carry with a private copy (+4.7 GB measured), while the
    single-iteration program does not.  `chain_steps` > 1 unrolls K
    iterations into each dispatched program (one dispatch per K iterations
    instead of per iteration); a remainder-length program covers
    `max_iter % K`, so exactly `max_iter` iterations run — chained and
    unchained dispatch produce the same iterate sequence.  The convergence
    check fetches one f32 scalar every `check_every` iterations (rounded up
    to chunk boundaries), and the norm history is fetched once at the end.
    """
    K = max(1, min(int(chain_steps), max_iter))
    step, init_state = _lcg_step_compiled(
        normal_op, M, x0.shape, str(x0.dtype), len(op_args), K
    )
    if state is None:
        x, r, z, p, rz, gnorm0, bnorm = init_state(x0, b, *op_args)
        bnorm_f = float(bnorm)
        gnorm0_f = float(gnorm0)
    else:
        x, r, z, p, rz = (jnp.asarray(s) for s in state)
        bnorm_f = float(jnp.linalg.norm(b.ravel()).astype(jnp.float32))
        gnorm0_f = float(jnp.linalg.norm(r.ravel()).astype(jnp.float32))
    norms = []
    it = 0
    next_check = check_every
    while it < max_iter:
        k = min(K, max_iter - it)
        stepk = step if k == K else _lcg_step_compiled(
            normal_op, M, x0.shape, str(x0.dtype), len(op_args), k
        )[0]
        x, r, z, p, rz, rnorms = stepk(x, r, z, p, rz, *op_args)
        norms.append(rnorms)
        it += k
        if it >= next_check or it >= max_iter:
            next_check = it + check_every
            if float(rnorms[-1]) <= tol * bnorm_f:
                break
    # n_iter reports the iterations actually run (x/state/grad_norm stay
    # mutually consistent); because convergence checks are batched every
    # `check_every` iterations, dispatch mode may overshoot the tolerance
    # crossing by up to check_every-1 extra iterations — harmless for an
    # SPD quadratic (the residual keeps decreasing), and `converged` is
    # still reported from the final norm.
    norms_np = np.asarray(jnp.concatenate(norms), np.float64)
    converged = bool(norms_np[-1] <= tol * bnorm_f)
    return x, norms_np, it, gnorm0_f, converged, (x, r, z, p, rz)


def lcg(
    normal_op: Callable,
    b,
    x0,
    max_iter: int = 100,
    tol: float = 1e-12,
    precond: Optional[Callable] = None,
    callback: Optional[Callable] = None,
    state=None,
    return_state: bool = False,
    op_args: tuple = (),
    loop: str = "graph",
    chain_steps: int = 1,
) -> SolverResult:
    """Linear CG for Q x = b with Q = `normal_op` (SPD).

    `op_args` are extra trailing arguments threaded through to `normal_op`
    on every application — device-resident model tables in the flagship's
    `window_local` mode (closed-over arrays would be inlined as HLO
    constants; arguments keep the compiled loop small).

    `tol` matches the qmm convention: stop when ‖∇J‖ = ‖Qx − b‖ ≤ tol·‖b‖.
    The loop runs entirely under jit; per-iteration gradient norms are
    accumulated on device and returned for telemetry.

    Pass `state` (a `SolverResult.state` from a previous run, the tuple
    (x, r, z, p, rz)) to resume EXACTLY — conjugate directions preserved, as
    if the solve had never been interrupted.  `return_state=True` attaches
    the final state to the result (the reference only supports warm
    restarts via `value_init`, fusion_CT.py:122-127, which reset conjugacy).
    """
    x0 = jnp.asarray(x0)
    b = jnp.asarray(b, x0.dtype)

    M = precond if precond is not None else None
    if loop == "dispatch":
        x, norms, it, gnorm0, converged, final_state = _lcg_dispatch(
            normal_op, b, x0, max_iter, tol, M, state, op_args,
            chain_steps=chain_steps,
        )
        res = SolverResult(
            x=np.asarray(x),
            grad_norm=np.concatenate([[float(gnorm0)], norms]),
            n_iter=it,
            converged=converged,
        )
        if return_state:
            res.state = tuple(np.asarray(s) for s in final_state)
        if callback is not None:
            callback(res)
        return res

    fresh = state is None
    run = _lcg_compiled(
        normal_op, M, max_iter, x0.shape, str(x0.dtype), fresh, len(op_args)
    )
    init = x0 if fresh else tuple(jnp.asarray(s) for s in state)
    x, norms, it, gnorm0, final_state = run(
        init, b, jnp.asarray(tol, x0.dtype), *op_args
    )
    # the iteration count comes back as an f32 scalar, like every other
    # scalar the solvers fetch
    it = int(float(jnp.asarray(it, jnp.float32)))
    norms = np.asarray(norms)[:it]
    res = SolverResult(
        x=np.asarray(x),
        grad_norm=np.concatenate([[float(gnorm0)], norms]),
        n_iter=it,
        converged=bool(it < max_iter),
    )
    if return_state:
        res.state = tuple(np.asarray(s) for s in final_state)
    if callback is not None:
        callback(res)
    return res


def _mmmg_body(normal_op, x, g, d_prev, q_prev, *op_args):
    """One MM memory-gradient iteration.  `q_prev` carries Q·d_prev from the
    previous step (exact by linearity: the new d is a·d0 + c·d_prev, so
    Q·d_new = a·q0 + c·q_prev) — ONE normal application per iteration
    instead of the naive two."""
    d0 = -g
    q0 = normal_op(d0, *op_args)
    q1 = q_prev
    # minimize J(x + a·d0 + c·d_prev): solve the 2×2 Gram system
    a00 = jnp.vdot(d0, q0, precision="highest").real
    a01 = jnp.vdot(d0, q1, precision="highest").real
    a11 = jnp.vdot(d_prev, q1, precision="highest").real
    g0d = jnp.vdot(g, d0, precision="highest").real
    g1d = jnp.vdot(g, d_prev, precision="highest").real
    det = a00 * a11 - a01 * a01
    safe = jnp.abs(det) > 1e-30
    a = jnp.where(safe, (-g0d * a11 + g1d * a01) / jnp.where(safe, det, 1.0), -g0d / a00)
    c = jnp.where(safe, (g0d * a01 - g1d * a00) / jnp.where(safe, det, 1.0), 0.0)
    step = a * d0 + c * d_prev
    x = x + step
    g = g + a * q0 + c * q1
    q_new = a * q0 + c * q1
    return x, g, step, q_new


def _mmmg_dispatch(normal_op, b, x0, max_iter, tol, op_args,
                   check_every: int = 25):
    """mmmg as Python-orchestrated per-iteration dispatches (the
    flagship-scale mode, same rationale as :func:`_lcg_dispatch`)."""
    key = ("mstep", id(normal_op), x0.shape, str(x0.dtype), len(op_args))
    if key in _MMMG_CACHE:
        step, init_state = _MMMG_CACHE[key][0]
    else:
        @jax.jit
        def step(x, g, d_prev, q_prev, *op_args):
            x, g, d, q = _mmmg_body(normal_op, x, g, d_prev, q_prev, *op_args)
            return x, g, d, q, jnp.linalg.norm(g.ravel()).astype(jnp.float32)

        @jax.jit
        def init_state(x0, b, *op_args):
            g0 = normal_op(x0, *op_args) - b
            q0 = normal_op(-g0, *op_args)
            alpha = jnp.vdot(g0, g0, precision="highest").real / jnp.vdot(-g0, q0, precision="highest").real
            x1 = x0 + alpha * (-g0)
            g1 = g0 + alpha * q0
            return (
                x1, g1, alpha * (-g0), alpha * q0,
                jnp.linalg.norm(g0.ravel()).astype(jnp.float32),
                jnp.linalg.norm(g1.ravel()).astype(jnp.float32),
                jnp.linalg.norm(b.ravel()).astype(jnp.float32),
            )

        _MMMG_CACHE[key] = ((step, init_state), normal_op)
    x, g, d, q, gnorm0, gnorm1, bnorm = init_state(x0, b, *op_args)
    bnorm_f, gnorm0_f = float(bnorm), float(gnorm0)
    norms = [gnorm1]
    it = 1
    while it < max_iter:
        x, g, d, q, gn = step(x, g, d, q, *op_args)
        norms.append(gn)
        it += 1
        if it % check_every == 0 or it == max_iter:
            if float(norms[-1]) <= tol * bnorm_f:
                break
    norms_np = np.asarray(jnp.stack(norms), np.float64)
    converged = bool(norms_np[-1] <= tol * bnorm_f)
    return x, norms_np, it, gnorm0_f, converged


def mmmg(
    normal_op: Callable,
    b,
    x0,
    max_iter: int = 100,
    tol: float = 1e-12,
    callback: Optional[Callable] = None,
    op_args: tuple = (),
    loop: str = "graph",
) -> SolverResult:
    """MM memory-gradient for the quadratic J(x) = ½xᵀQx − bᵀx.

    Each step minimizes J exactly over span{−∇J, x − x_prev} (a 2×2 linear
    solve) — the quadratic specialization of `qmm.mmmg`, at ONE normal
    application per iteration (Q·d_prev is carried by linearity).
    `op_args` / `loop` as in :func:`lcg` (`loop="dispatch"` keeps the
    iteration out of the graph — mandatory at flagship scale, where the
    while-loop carry would hold a private copy of every table).
    """
    x0 = jnp.asarray(x0)
    b = jnp.asarray(b, x0.dtype)

    if loop == "dispatch":
        x, norms, it, gnorm0, converged = _mmmg_dispatch(
            normal_op, b, x0, max_iter, tol, op_args
        )
        res = SolverResult(
            x=np.asarray(x),
            grad_norm=np.concatenate([[gnorm0], norms]),
            n_iter=it,
            converged=converged,
        )
        if callback is not None:
            callback(res)
        return res

    key = (id(normal_op), max_iter, x0.shape, str(x0.dtype), len(op_args))
    if key in _MMMG_CACHE:
        x, norms, it, gnorm0 = _MMMG_CACHE[key][0](
            x0, b, jnp.asarray(tol, x0.dtype), *op_args
        )
        it = int(float(jnp.asarray(it, jnp.float32)))
        res = SolverResult(
            x=np.asarray(x),
            grad_norm=np.concatenate([[float(gnorm0)], np.asarray(norms)[:it]]),
            n_iter=it,
            converged=bool(it < max_iter),
        )
        if callback is not None:
            callback(res)
        return res

    @jax.jit
    def run(x0, b, tol, *op_args):
        g0 = normal_op(x0, *op_args) - b
        bnorm = jnp.linalg.norm(b.ravel())
        norms = jnp.zeros((max_iter,), x0.dtype)

        def cond(state):
            x, g, d_prev, q_prev, it, norms = state
            return jnp.logical_and(it < max_iter, jnp.linalg.norm(g.ravel()) > tol * bnorm)

        def body(state):
            x, g, d_prev, q_prev, it, norms = state
            x, g, step, q_new = _mmmg_body(
                normal_op, x, g, d_prev, q_prev, *op_args
            )
            norms = norms.at[it].set(jnp.linalg.norm(g.ravel()))
            return x, g, step, q_new, it + 1, norms

        # first iteration: steepest descent (no memory direction yet)
        q0 = normal_op(-g0, *op_args)
        alpha = jnp.vdot(g0, g0, precision="highest").real / jnp.vdot(-g0, q0, precision="highest").real
        x1 = x0 + alpha * (-g0)
        g1 = g0 + alpha * q0
        norms = norms.at[0].set(jnp.linalg.norm(g1.ravel()))
        state = (x1, g1, alpha * (-g0), alpha * q0, jnp.asarray(1), norms)
        x, g, d, q, it, norms = jax.lax.while_loop(cond, body, state)
        return x, norms, it, jnp.linalg.norm(g0.ravel())

    _MMMG_CACHE[key] = (run, normal_op)
    x, norms, it, gnorm0 = run(x0, b, jnp.asarray(tol, x0.dtype), *op_args)
    # the iteration count comes back as an f32 scalar (as in lcg)
    it = int(float(jnp.asarray(it, jnp.float32)))
    res = SolverResult(
        x=np.asarray(x),
        grad_norm=np.concatenate([[float(gnorm0)], np.asarray(norms)[:it]]),
        n_iter=it,
        converged=bool(it < max_iter),
    )
    if callback is not None:
        callback(res)
    return res
