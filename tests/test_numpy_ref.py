"""Backend equivalence: JAX pipeline vs independent NumPy reference path.

The JAX rebuild's analog of the reference's `test/test_accel_accuracy.py`
(NumPy ↔ JAX ↔ Cython kernel cross-checks).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.core import numpy_ref
from surfh_tpu.simulation.synthetic import make_model


@pytest.fixture(scope="module")
def problem():
    return make_model(
        im_size=31,
        n_lambda=24,
        n_tpl=3,
        n_channels=2,
        n_pointings=2,
        n_slit=3,
        dtype=jnp.float64,
    )


def test_numpy_forward_matches_jax(problem):
    model, setup = problem
    y_jax = np.asarray(model.forward(setup["maps"]))
    y_np = numpy_ref.spectro_forward(model, setup["maps"])
    np.testing.assert_allclose(y_np, y_jax, rtol=1e-8, atol=1e-10)


def test_numpy_adjoint_matches_jax(problem):
    model, setup = problem
    rng = np.random.default_rng(11)
    y = rng.standard_normal(model.oshape)
    a_jax = np.asarray(model.adjoint(y))
    a_np = numpy_ref.spectro_adjoint(model, y)
    np.testing.assert_allclose(a_np, a_jax, rtol=1e-8, atol=1e-8)


def test_numpy_path_is_self_adjoint(problem):
    model, setup = problem
    rng = np.random.default_rng(5)
    x = rng.standard_normal(model.ishape)
    y = rng.standard_normal(model.oshape)
    lhs = np.vdot(numpy_ref.spectro_forward(model, x), y)
    rhs = np.vdot(x, numpy_ref.spectro_adjoint(model, y))
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs)) < 1e-10
