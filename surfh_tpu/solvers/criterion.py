"""Regularized least-squares criteria for MRS fusion.

Behavioural reference: `QuadCriterion_MRS`
(/root/reference/surfh/Simulation/fusion_CT.py:67-266) and its 2-D twin
(criterion_2D.py).  J(x) = µ_s/2·‖Hx − y‖² + µ_r/2·(‖D_r x‖² + ‖D_c x‖²)
with circular first-difference priors over the spatial axes of each map (or a
joint Fourier Laplacian).  The normal operator Q = µ_s HᵗH + µ_r DᵀD is one
fused jitted function; solving uses :func:`surfh_tpu.solvers.cg.lcg` /
:func:`mmmg` entirely on device.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core import fft
from ..core.linop import build_transpose
from .cg import SolverResult, lcg, mmmg


def diff_rows(x):
    """Circular first difference over axis 1: (Dx)[i] = x[i-1] − x[i].

    Reference NpDiff_r (fusion_CT.py:16-29)."""
    return jnp.roll(x, 1, axis=1) - x


def diff_rows_t(y):
    return jnp.roll(y, -1, axis=1) - y


def diff_cols(x):
    """Circular first difference over axis 2 (reference NpDiff_c)."""
    return jnp.roll(x, 1, axis=2) - x


def diff_cols_t(y):
    return jnp.roll(y, -1, axis=2) - y


def dtd_separated(x):
    """(D_rᵀD_r + D_cᵀD_c) x — the circular 2-D Laplacian per map."""
    return (
        4 * x
        - jnp.roll(x, 1, axis=1)
        - jnp.roll(x, -1, axis=1)
        - jnp.roll(x, 1, axis=2)
        - jnp.roll(x, -1, axis=2)
    )


class DifferenceOperatorJoint:
    """Joint Laplacian prior in Fourier (reference fusion_CT.py:45-63)."""

    def __init__(self, shape_target, dtype=jnp.float32):
        # host NumPy, not device: jit embeds the host constant (same rule as
        # the channel/blind2d tables)
        ctype = np.complex64 if dtype == jnp.float32 else np.complex128
        self.d_freq = np.asarray(
            fft.ir2fr(fft.laplacian(2), tuple(shape_target))[np.newaxis], ctype
        )
        self.shape_target = tuple(shape_target)

    def D(self, x):
        return fft.idft(fft.dft(x) * self.d_freq, self.shape_target)

    def D_t(self, x):
        return fft.idft(fft.dft(x) * self.d_freq.conj(), self.shape_target)

    def DtD(self, x):
        return fft.idft(fft.dft(x) * jnp.abs(self.d_freq) ** 2, self.shape_target)


class QuadCriterion_MRS:
    """J(x) = µ_s/2‖Hx−y‖² + µ_r/2‖Dx‖², minimized by on-device CG/MM-MG.

    Accepts any model exposing `forward_fn` (pure) and `ishape/oshape/dtype`
    (all `surfh_tpu.models` operators do).
    """

    def __init__(
        self,
        mu_spectro: float,
        y_spectro,
        model_spectro,
        mu_reg: float,
        printing: bool = False,
        gradient: str = "separated",
        use_fwadj: bool = False,
    ):
        """`use_fwadj=True` applies HᵗH through the model's fused `fwadj`
        (e.g. the block-Fourier Hessian of `Model_WCT`) instead of
        adjoint∘forward — the reference's `hessp=model.fwadj` option
        (fusion_mixing.py:132-139)."""
        self.mu_spectro = float(mu_spectro)
        self.model = model_spectro
        self.mu_reg = mu_reg
        self.printing = printing
        self.gradient = gradient
        self.shape_of_output = tuple(model_spectro.ishape)
        self.dtype = model_spectro.dtype

        self.y_spectro = jnp.asarray(y_spectro, self.dtype).reshape(model_spectro.oshape)

        fwd = model_spectro.forward_fn if hasattr(model_spectro, "forward_fn") else model_spectro.forward
        self._fwd = fwd
        # Extra trailing op args (device-resident tables in the flagship's
        # window_local mode) threaded through every operator application.
        self._op_args = (
            model_spectro.solver_args() if hasattr(model_spectro, "solver_args") else ()
        )
        if hasattr(model_spectro, "adjoint_fn"):
            # hand-optimized exact transpose (e.g. SpectroSigRLSCT.adjoint_fn)
            adj_fn = jax.jit(model_spectro.adjoint_fn)
            self._adj = lambda y, *a: (adj_fn(y, *a),)
        else:
            primal = jax.ShapeDtypeStruct(self.shape_of_output, self.dtype)
            transpose = build_transpose(fwd, primal)
            tjit = jax.jit(lambda y: transpose(y))
            self._adj = tjit

        if gradient == "joint":
            self._joint = DifferenceOperatorJoint(self.shape_of_output[1:], self.dtype)
        elif gradient != "separated":
            raise ValueError(f"unknown gradient mode {gradient!r}")

        mu_s, mu_r = self.mu_spectro, self.mu_reg
        if use_fwadj and not hasattr(model_spectro, "fwadj"):
            raise ValueError("use_fwadj=True requires the model to define fwadj")
        fwadj = model_spectro.fwadj if use_fwadj else None

        # Prefer a fused HᵗH when the model provides one (the window_local
        # flagship's per-channel fwd∘adj avoids materializing the flat y).
        fused_normal = getattr(model_spectro, "_normal_fn_tabled", None)
        use_fused = (
            fwadj is None
            and fused_normal is not None
            and getattr(model_spectro, "window_local", False)
        )

        # ONE normal_op per (model, gradient mode, Hessian path): the µ's
        # ride as TRACED arguments, so every criterion instance built on
        # the same model (µ sweeps, warm restarts) reuses the solver's
        # compiled step program — the solver cache keys on the closure's
        # identity, and a fresh closure per criterion would re-trace the
        # (at flagship scale, large) normal program on every solve.
        cache = getattr(model_spectro, "_criterion_fn_cache", None)
        if cache is None:
            cache = {}
            try:
                model_spectro._criterion_fn_cache = cache
            except AttributeError:
                pass  # slotted/frozen model: fall back to per-instance
        key = (gradient, fwadj is not None, use_fused)
        if key in cache:
            self.normal_op = cache[key]
        else:
            adj = self._adj
            joint = self._joint if gradient == "joint" else None

            def normal_op(x, mu_s, mu_r, *op_args):
                if fwadj is not None:
                    hthx = fwadj(x)
                elif use_fused:
                    hthx = fused_normal(x, *op_args)
                else:
                    hthx = adj(fwd(x, *op_args), *op_args)[0]
                reg = dtd_separated(x) if joint is None else joint.DtD(x)
                return mu_s * hthx + mu_r * reg

            cache[key] = normal_op
            self.normal_op = normal_op
        self._mu_args = (
            jnp.asarray(self.mu_spectro, self.dtype),
            jnp.asarray(float(self.mu_reg), self.dtype),
        )
        self._b = None
        self.L_crit_val: list = []

    @property
    def b(self):
        if self._b is None:
            self._b = self.mu_spectro * self._adj(self.y_spectro, *self._op_args)[0]
        return self._b

    def run_method(
        self,
        method: str = "lcg",
        maximum_iterations: int = 10,
        tolerance: float = 1e-12,
        calc_crit: bool = False,
        perf_crit=None,
        value_init: Union[float, np.ndarray] = 0.5,
        solver_state=None,
        return_state: bool = False,
        solver_loop: str = "graph",
        solver_chain: int = 1,
    ) -> SolverResult:
        if isinstance(value_init, (int, float)):
            init = jnp.full(self.shape_of_output, value_init, self.dtype)
        else:
            init = jnp.asarray(value_init, self.dtype).reshape(self.shape_of_output)

        import time

        t0 = time.perf_counter()
        op_args = self._mu_args + self._op_args
        if method == "lcg":
            res = lcg(
                self.normal_op, self.b, init, max_iter=maximum_iterations,
                tol=tolerance, state=solver_state, return_state=return_state,
                op_args=op_args, loop=solver_loop,
                chain_steps=solver_chain,
            )
        else:
            res = mmmg(
                self.normal_op, self.b, init, max_iter=maximum_iterations,
                tol=tolerance, op_args=op_args, loop=solver_loop,
            )
        if self.printing:
            print(f"Total time needed for {method}: {time.perf_counter() - t0:.3f}s")
        if calc_crit:
            self.L_crit_val.append(self.get_crit_val(res.x))
            res.crit_val = np.asarray(self.L_crit_val)
        return res

    def get_crit_val(self, x_hat) -> float:
        # One jitted program per criterion instance: the tabled flagship
        # forward dispatched eagerly would pay one dispatch per op.
        if getattr(self, "_crit_jit", None) is None:

            def crit(x_hat, y, *op_args):
                data_term = self.mu_spectro * jnp.sum(
                    (y - self._fwd(x_hat, *op_args)) ** 2
                )
                if self.gradient == "separated":
                    reg = self.mu_reg * jnp.sum(
                        diff_rows(x_hat) ** 2 + diff_cols(x_hat) ** 2
                    )
                else:
                    reg = self.mu_reg * jnp.sum(self._joint.D(x_hat) ** 2)
                # f32 scalar result, like the solvers' fetched norms
                return ((data_term + reg) / 2).astype(jnp.float32)

            self._crit_jit = jax.jit(crit)
        x_hat = jnp.asarray(x_hat, self.dtype).reshape(self.shape_of_output)
        return float(self._crit_jit(x_hat, self.y_spectro, *self._op_args))


# The 2-D single-λ criterion has identical structure over [Nx, Ny] images; the
# difference operators act on axes 0/1 instead of 1/2.
class QuadCriterion_MRS_2D(QuadCriterion_MRS):
    """2-D deconvolution criterion (reference criterion_2D.py)."""

    def __init__(self, mu_spectro, y_spectro, model_spectro, mu_reg, printing=False, gradient="separated"):
        super().__init__(mu_spectro, y_spectro, model_spectro, mu_reg, printing, "separated")
        if gradient != "separated":
            raise NotImplementedError("2-D criterion supports the separated prior")
        fwd = self._fwd
        adj = self._adj

        # same µ-as-op-args / model-memoized pattern as the parent (the
        # difference operators act on axes 0/1 of the 2-D image)
        cache = getattr(model_spectro, "_criterion_fn_cache", None)
        if cache is None:
            cache = {}
            try:
                model_spectro._criterion_fn_cache = cache
            except AttributeError:
                pass
        key = ("separated-2d", False, False)
        if key in cache:
            self.normal_op = cache[key]
        else:

            def normal_op(x, mu_s, mu_r, *op_args):
                hthx = adj(fwd(x))[0]
                reg = (
                    4 * x
                    - jnp.roll(x, 1, axis=0)
                    - jnp.roll(x, -1, axis=0)
                    - jnp.roll(x, 1, axis=1)
                    - jnp.roll(x, -1, axis=1)
                )
                return mu_s * hthx + mu_r * reg

            cache[key] = normal_op
            self.normal_op = normal_op

    def get_crit_val(self, x_hat) -> float:
        x_hat = jnp.asarray(x_hat, self.dtype).reshape(self.shape_of_output)
        data_term = self.mu_spectro * jnp.sum((self.y_spectro - self._fwd(x_hat)) ** 2)
        dr = jnp.roll(x_hat, 1, axis=0) - x_hat
        dc = jnp.roll(x_hat, 1, axis=1) - x_hat
        reg = self.mu_reg * jnp.sum(dr**2 + dc**2)
        return float((data_term + reg) / 2)
