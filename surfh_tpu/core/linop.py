"""Linear operator protocol and adjoint verification.

Self-contained replacement for the `aljabr.LinOp` / `aljabr.dottest` pair the
reference builds on (used at e.g. /root/reference/surfh/Models/spectroModel.py:39
and /root/reference/test/test_fw_ad.py:35).  Operators here are thin stateful
wrappers around pure jittable functions; adjoints are usually *derived* with
`jax.linear_transpose`, which guarantees ⟨Hx, y⟩ = ⟨x, Hᵗy⟩ to floating-point
precision by construction.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Shape = Tuple[int, ...]


def build_transpose(fwd: Callable, primal) -> Callable:
    """Exact transpose of a linear `fwd`.

    Implemented as the VJP at a zero primal: for a linear map the VJP *is*
    the transpose (exact, not approximate), and unlike `jax.linear_transpose`
    it supports `lax.scan` bodies (jax 0.9's scan transpose rule chokes on
    non-linear scanned inputs such as gather-plan tables).  The unused primal
    output and zero-input forward pass are dead-code-eliminated by XLA under
    jit, so the compiled program is the same as the hand-derived transpose.
    """

    def transpose(cotangent):
        zeros = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, p.dtype), primal
        )
        _, vjp_fn = jax.vjp(fwd, zeros)
        return vjp_fn(cotangent)

    return transpose


class LinOp:
    """A linear operator with explicit input/output shapes.

    Subclasses implement :meth:`forward`; :meth:`adjoint` defaults to the exact
    linear transpose of :meth:`forward` (computed once, jitted, cached).

    Attributes
    ----------
    ishape, oshape:
        Input/output array shapes.
    dtype:
        Computation dtype of the operator (default float32).
    """

    def __init__(self, ishape: Shape, oshape: Shape, dtype=jnp.float32):
        self.ishape = tuple(int(s) for s in ishape)
        self.oshape = tuple(int(s) for s in oshape)
        self.dtype = dtype
        self._transpose_fn: Optional[Callable] = None

    # -- to be provided by subclasses ------------------------------------
    def forward(self, x):
        raise NotImplementedError

    # -- derived ---------------------------------------------------------
    def adjoint(self, y):
        """Exact transpose of :meth:`forward` (derived automatically)."""
        if self._transpose_fn is None:
            fwd = lambda x: self.forward(x)
            primal = jax.ShapeDtypeStruct(self.ishape, self.dtype)
            transpose = build_transpose(fwd, primal)

            def _adj(y):
                (x,) = transpose(jnp.asarray(y, self.dtype).reshape(self.oshape))
                return x

            self._transpose_fn = jax.jit(_adj)
        return self._transpose_fn(y)

    def fwadj(self, x):
        """H^T H x — override when a fused/faster version exists."""
        return self.adjoint(self.forward(x))

    # -- conveniences ----------------------------------------------------
    @property
    def isize(self) -> int:
        return int(np.prod(self.ishape))

    @property
    def osize(self) -> int:
        return int(np.prod(self.oshape))

    def __call__(self, x):
        return self.forward(x)

    def matvec(self, x):
        return np.asarray(self.forward(np.reshape(x, self.ishape))).ravel()

    def rmatvec(self, y):
        return np.asarray(self.adjoint(np.reshape(y, self.oshape))).ravel()


class FuncLinOp(LinOp):
    """LinOp from a pure function ``fwd(x) -> y``."""

    def __init__(self, fwd: Callable, ishape: Shape, oshape: Shape, dtype=jnp.float32, jit: bool = True):
        super().__init__(ishape, oshape, dtype)
        self._fwd = jax.jit(fwd) if jit else fwd

    def forward(self, x):
        return self._fwd(jnp.asarray(x, self.dtype).reshape(self.ishape))


def dottest(
    op: LinOp,
    num: int = 5,
    rtol: float = 1e-5,
    echo: bool = False,
    seed: int = 0,
) -> bool:
    """Adjoint-consistency test: ⟨H x, y⟩ ≈ ⟨x, Hᵗ y⟩ for random x, y.

    Mirrors the contract of `aljabr.dottest` that backs the reference test
    suite (/root/reference/test/test_fw_ad.py).  Runs `num` random trials and
    checks the relative discrepancy of the two inner products.
    """
    rng = np.random.default_rng(seed)
    ok = True
    for _ in range(num):
        x = rng.standard_normal(op.ishape).astype(np.asarray(jnp.zeros(0, op.dtype)).dtype)
        y = rng.standard_normal(op.oshape).astype(x.dtype)
        hx = np.asarray(op.forward(x)).ravel()
        hty = np.asarray(op.adjoint(y)).ravel()
        lhs = np.vdot(hx, y.ravel())
        rhs = np.vdot(x.ravel(), hty)
        denom = max(abs(lhs), abs(rhs), 1e-30)
        rel = abs(lhs - rhs) / denom
        if echo:
            print(f"dottest: <Hx,y>={lhs:.8e} <x,Hty>={rhs:.8e} rel={rel:.3e}")
        ok = ok and bool(rel <= rtol)
    return ok
