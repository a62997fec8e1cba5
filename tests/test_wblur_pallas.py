"""Banded spectral blur (plain-JAX slab gathers + one batched einsum):
exactness vs the dense XLA contraction, and its plan's coverage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.core import wblur
from surfh_tpu.core.wblur_banded import (
    build_band_plan,
    wblur_sum_beta_banded,
    wblur_sum_beta_banded_reference,
)
from surfh_tpu.simulation.synthetic import make_model


def _banded_wpsf(K=200, W=120, B=6, width=3.0):
    wpsf = np.zeros((K, W, B))
    ls = np.arange(W)
    for k in range(K):
        c = k * (W - 1) / (K - 1)
        prof = np.exp(-0.5 * ((ls - c) / width) ** 2)
        prof[prof < 1e-4] = 0.0
        wpsf[k] = prof[:, None] * (1 + 0.1 * np.arange(B))[None, :]
    return wpsf


def test_band_plan_covers_support():
    wpsf = _banded_wpsf()
    plan = build_band_plan(wpsf)
    assert plan.density < 1.0
    # every nonzero of wpsf must fall inside its tile's band
    for t in range(plan.n_tiles):
        s = int(plan.starts[t])
        ks = slice(t * plan.TK, min((t + 1) * plan.TK, plan.K))
        outside = np.abs(wpsf[ks, : s, :]).max() if s > 0 else 0.0
        outside2 = (
            np.abs(wpsf[ks, s + plan.LB :, :]).max()
            if s + plan.LB < plan.W
            else 0.0
        )
        assert outside == 0.0 and outside2 == 0.0


def test_banded_matches_dense_interpret():
    rng = np.random.default_rng(0)
    wpsf = _banded_wpsf()
    plan = build_band_plan(wpsf)
    windows = rng.standard_normal((4, 120, 9, 6)).astype(np.float32)
    dense = np.asarray(
        wblur.wblur_sum_beta_batched(jnp.asarray(windows), jnp.asarray(wpsf, jnp.float32))
    )
    ref = wblur_sum_beta_banded_reference(windows, plan)
    np.testing.assert_allclose(ref, dense, atol=2e-4)
    out = np.asarray(wblur_sum_beta_banded(jnp.asarray(windows), plan))
    np.testing.assert_allclose(out, dense, atol=2e-4)


def test_flagship_banded_forward_matches_dense():
    kw = dict(im_size=31, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)
    dense_model, setup = make_model(**kw)
    banded_model, _ = make_model(**kw, wblur_impl="banded")
    y_dense = np.asarray(dense_model.forward(setup["maps"]))
    y_banded = np.asarray(banded_model.forward(setup["maps"]))
    np.testing.assert_allclose(y_banded, y_dense, rtol=1e-4, atol=1e-4)
    # adjoint (fast path, einsum-based) still pairs exactly with the forward
    rng = np.random.default_rng(1)
    yr = rng.standard_normal(banded_model.oshape).astype(np.float32)
    lhs = np.vdot(y_banded, yr)
    rhs = np.vdot(setup["maps"].astype(np.float32), np.asarray(banded_model.adjoint(yr)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-3


def test_banded_adjoint_matches_dense_interpret():
    from surfh_tpu.core.wblur_banded import build_band_plan_t, wblur_sum_beta_t_banded

    rng = np.random.default_rng(1)
    wpsf = _banded_wpsf()
    plan_t = build_band_plan_t(wpsf)
    y = rng.standard_normal((4, 200, 9)).astype(np.float32)
    dense = np.einsum("ska,klb->slab", y, wpsf).astype(np.float32)
    assert plan_t.KB < plan_t.K  # the transpose plan is banded too
    out = np.asarray(wblur_sum_beta_t_banded(jnp.asarray(y), plan_t))
    np.testing.assert_allclose(out, dense, atol=2e-4)


def test_flagship_banded_adjoint_matches_dense():
    kw = dict(im_size=31, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)
    dense_model, setup = make_model(**kw)
    banded_model, _ = make_model(**kw, wblur_impl="banded")
    rng = np.random.default_rng(2)
    y = rng.standard_normal(dense_model.oshape).astype(np.float32)
    a_dense = np.asarray(dense_model.adjoint(y))
    a_banded = np.asarray(banded_model.adjoint(y))
    np.testing.assert_allclose(a_banded, a_dense, rtol=1e-4, atol=2e-4 * np.abs(a_dense).max())


def test_band_rtol_accuracy_contract():
    """wblur_band_rtol trades FLOPs for a truncation error of its order."""
    kw = dict(im_size=31, n_lambda=200, n_tpl=3, n_channels=1, n_pointings=1,
              n_slit=3, detector_oversample=4)
    exact_model, setup = make_model(**kw)
    approx_model, _ = make_model(**kw, wblur_impl="banded", wblur_band_rtol=1e-3)
    plan = approx_model.channels[0].band_plan()
    assert plan.density < 1.0  # the threshold actually created a band
    y_exact = np.asarray(exact_model.forward(setup["maps"]))
    y_approx = np.asarray(approx_model.forward(setup["maps"]))
    rel = np.abs(y_approx - y_exact).max() / np.abs(y_exact).max()
    assert rel < 5e-2  # truncation error bounded (heavy sinc² tails)
    assert rel > 0  # and it is an approximation, not a no-op
