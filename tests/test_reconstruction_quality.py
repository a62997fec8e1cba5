"""End-to-end reconstruction fidelity on an Orion-like simulated scene.

The reference validates by scripts/notebooks comparing reconstructed maps to
the simulated ground truth (fusion_MCMO_SigRLSCT_simulated.py:245-263,
metrics helpers).  Here the same loop is an asserted test: synthesize data
with the flagship model from a smooth abundance scene, reconstruct with CG,
and require quantitative improvement over both the initialization and a
short run.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.simulation.data import synthetic_orion
from surfh_tpu.simulation.synthetic import make_setup
from surfh_tpu.solvers.criterion import QuadCriterion_MRS
from surfh_tpu.utils import metrics


@pytest.fixture(scope="module")
def problem():
    from surfh_tpu.models.spectro import SpectroSigRLSCT

    setup = make_setup(
        im_size=61, n_lambda=40, n_tpl=3, n_channels=2, n_pointings=2, n_slit=5
    )
    # replace the random maps with a smooth Orion-like scene (the prior
    # matches smooth scenes, so CG should reconstruct it well)
    maps, _, _, _ = synthetic_orion(n_maps=3, size=61, n_wavel=16)
    maps = maps / maps.max()
    model = SpectroSigRLSCT(
        setup["sotf"],
        setup["templates"],
        setup["alpha_axis"],
        setup["beta_axis"],
        setup["wavelength_axis"],
        setup["instrs"],
        setup["step_degree"],
        setup["pointings"],
        dtype=jnp.float64,
    )
    y = np.asarray(model.forward(maps))
    return model, maps, y


def _coverage_mask(model):
    """Spatial pixels actually observed (nonzero sensitivity): |Hᵗ1| > tol."""
    ones = np.ones(model.oshape)
    sens = np.abs(np.asarray(model.adjoint(ones))).sum(axis=0)
    return sens > 0.05 * sens.max()


def test_cg_reconstruction_improves_with_iterations(problem):
    model, truth, y = problem
    mask = _coverage_mask(model)
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg=5.0)
    short = crit.run_method("lcg", maximum_iterations=5, value_init=0.0)
    long = crit.run_method("lcg", maximum_iterations=80, value_init=0.0)
    deep = crit.run_method("lcg", maximum_iterations=300, value_init=0.0)
    # fidelity is only meaningful inside the observed FOV: the maps outside
    # coverage are set by the prior alone
    err_short = metrics.relative_error(truth[:, mask], short.x[:, mask])
    err_long = metrics.relative_error(truth[:, mask], long.x[:, mask])
    err_deep = metrics.relative_error(truth[:, mask], deep.x[:, mask])
    assert err_deep < err_long < err_short
    # measured-constant regression bounds (float64 CPU, deterministic):
    # 14.39% @ 80 iters, 10.77% @ 300 iters, PSNR 18.78 dB @ 300 — pinned
    # with ~3% slack, not improvement-only checks
    assert err_long < 14.8  # percent
    assert err_deep < 11.2  # percent
    assert metrics.psnr(truth[:, mask], deep.x[:, mask]) > 18.55


def test_criterion_value_decreases(problem):
    model, truth, y = problem
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg=5.0)
    r1 = crit.run_method("lcg", maximum_iterations=3, value_init=0.0, calc_crit=True)
    r2 = crit.run_method("lcg", maximum_iterations=40, value_init=0.0, calc_crit=True)
    assert crit.get_crit_val(r2.x) < crit.get_crit_val(r1.x)


def test_mmmg_agrees_with_lcg(problem):
    model, truth, y = problem
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg=5.0)
    a = crit.run_method("lcg", maximum_iterations=60, value_init=0.0)
    b = crit.run_method("mmmg", maximum_iterations=120, value_init=0.0)
    # both minimize the same strictly convex quadratic; the memory-gradient
    # converges more slowly, so compare criterion values, not iterates
    ja, jb = crit.get_crit_val(a.x), crit.get_crit_val(b.x)
    j0 = crit.get_crit_val(np.zeros(model.ishape))
    assert (jb - ja) / (j0 - ja) < 0.02


@pytest.fixture(scope="module")
def ngc_problem():
    """Second scene morphology: the NGC 7023 stand-in
    — bright point sources over narrow curved filaments, sharp small-scale
    structure that stresses the reconstruction instead of flattering the
    smoothness prior like the Orion fronts do."""
    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.simulation.data import synthetic_ngc7023

    setup = make_setup(
        im_size=61, n_lambda=40, n_tpl=3, n_channels=2, n_pointings=2, n_slit=5
    )
    maps, _, _, _ = synthetic_ngc7023(n_maps=3, size=61, n_wavel=16)
    maps = maps / maps.max()
    model = SpectroSigRLSCT(
        setup["sotf"], setup["templates"], setup["alpha_axis"],
        setup["beta_axis"], setup["wavelength_axis"], setup["instrs"],
        setup["step_degree"], setup["pointings"], dtype=jnp.float64,
    )
    y = np.asarray(model.forward(maps))
    return model, maps, y


def test_ngc7023_scene_reconstruction(ngc_problem):
    """Absolute fidelity bar on the point-source + filament scene
    (measured constants: 27.68% rel-err / PSNR 25.77 at µ=5, 300 iters,
    float64 CPU, deterministic; ~3% slack)."""
    model, truth, y = ngc_problem
    mask = _coverage_mask(model)
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg=5.0)
    res = crit.run_method("lcg", maximum_iterations=300, value_init=0.0)
    err = metrics.relative_error(truth[:, mask], res.x[:, mask])
    assert err < 28.6  # percent
    assert metrics.psnr(truth[:, mask], res.x[:, mask]) > 25.5


def test_noise_regularization_tradeoff(ngc_problem):
    """Under 2% data noise the µ sweep behaves like a real L-curve:
    stronger regularization beats the noiseless-optimal µ, and the best
    reconstruction stays under an absolute bar (measured 47.25% / PSNR
    23.45 at µ=50; under-regularized µ=0.5 blows up to 161%)."""
    model, truth, y = ngc_problem
    mask = _coverage_mask(model)
    rng = np.random.default_rng(0)
    yrms = float(np.sqrt(np.mean(y**2)))
    yn = y + 0.02 * yrms * rng.standard_normal(y.shape)
    errs = {}
    for mu in (0.5, 50.0):
        crit = QuadCriterion_MRS(1.0, yn, model, mu_reg=mu)
        res = crit.run_method("lcg", maximum_iterations=300, value_init=0.0)
        errs[mu] = metrics.relative_error(truth[:, mask], res.x[:, mask])
    assert errs[50.0] < errs[0.5]  # regularization recovers fidelity
    assert errs[50.0] < 49.0  # percent (measured 47.25, ~3% slack)
