"""Matmul input-precision policy for the f32 contractions.

On a GPU, XLA may run an f32 `jnp.einsum`/`jnp.matmul`/`lax.dot_general`
that names no precision (`precision="default"`) on the tensor cores in TF32:
the operands are rounded to 10 mantissa bits, so a [K,W]·[W,N] contraction
carries a ~1e-3-class relative error even though the accumulator
(`preferred_element_type`) is f32.  That breaks the float32 dot tests and
the CG conjugacy the solvers rely on, and the framework's fidelity bar is
float32 (BASELINE.json), so every accuracy-relevant GEMM pins
`precision=gemm_precision()`:

* ``highest`` (default) — full f32 (no TF32; on the H100 the f32 FMA units,
  ~67 TFLOP/s peak);
* ``high`` — the backend may use a faster multi-pass scheme (3×TF32 /
  bf16-split, ~1e-6-class deviation);
* ``default`` — the backend's fastest (TF32 on the tensor cores),
  TF32-class accuracy.

``SURFH_GEMM_PRECISION`` overrides at model/trace time (the value is read
when the jitted function is traced, like the other SURFH_* knobs).  The
conv matmuls have their own knob (``conv_precision``, models/spectro.py)
and are already pinned.

On CPU the flag is a no-op (f32 units are exact f32), so the 8-virtual-
device test suite is unaffected.
"""

import os

_VALID = ("default", "high", "highest")


def gemm_precision(default: str = "highest") -> str:
    """The input-precision string for accuracy-relevant f32 contractions."""
    p = os.environ.get("SURFH_GEMM_PRECISION", default)
    if p not in _VALID:
        raise ValueError(
            f"SURFH_GEMM_PRECISION={p!r} invalid; expected one of {_VALID}"
        )
    return p
