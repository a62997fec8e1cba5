"""End-to-end reconstruction A/B against the reference pipeline.

Closes the one contract no operator-level test can falsify: both sides
run the *full criterion+solver semantics* — the
reference's `QuadCriterion_MRS.run_method('lcg')`
(/root/reference/surfh/Simulation/fusion_CT.py:118-238, with a textbook-CG
stand-in for the absent `qmm.lcg`, see
`reference_harness.reference_lcg_solve`) — to ≥100 iterations on an
identical small multi-channel problem, and the reconstructed maps must
agree to float32-class tolerance (measured: ~4e-13 relative).

Finding locked in by these tests: the reference's gridding adjoint
(fill-0 reverse interpolation, cython_utils.py:53-58) is NOT the exact
transpose of its forward (clamped-extrapolation interpolation), so the
reference's CG converges to a fixed point that is ~1% away from the true
minimizer of its own criterion J.  The literal maps A/B therefore runs
our pipeline with the reference-parity `adjoint_interp` composed exactly
as spectroModel.py:173-185; separately we assert that our production
exact-transpose solve achieves a strictly LOWER criterion value than the
reference's own solve — the framework reconstructs better than the
reference by the reference's own metric.
"""

import numpy as np
import pytest

import reference_harness as rh
from test_channel_parity import _build_flagship_pair

pytestmark = pytest.mark.skipif(
    not rh.reference_available(), reason="reference checkout absent"
)

MU_SPECTRO = 1.0
MU_REG = 5e3  # the flagship run's µ (fusion_real_data_multi_chan.py:443-461)
NITER = 100


class _OursReferenceAdjointShim:
    """Our forward + the reference-semantics adjoint, composed per
    spectroModel.py:173-185: per-channel `adjoint_interp` (the
    reverse-interpolation adjoint, parity-locked at 1e-15 by
    test_channel_parity) scatter-added into λ-windows → conj-C → Tᵗ."""

    def __init__(self, ours):
        from surfh_tpu.core import fft, lmm

        self._ours = ours
        self._fft, self._lmm = fft, lmm
        self.ishape = tuple(ours.ishape)

    def forward(self, x):
        return np.asarray(self._ours.forward(x)).ravel()

    def adjoint(self, yv):
        ours = self._ours
        yv = np.asarray(yv).ravel()
        cube = np.zeros(ours.cube_shape)
        for c, chan in enumerate(ours.channels):
            block = yv[int(ours._idx[c]) : int(ours._idx[c + 1])].reshape(
                chan.oshape
            )
            cube[chan.wslice.start : chan.wslice.stop] += np.asarray(
                chan.adjoint_interp(block)
            )
        blurred_t = np.asarray(
            self._fft.idft(
                self._fft.dft(cube) * np.conj(np.asarray(ours._sotf_dev)),
                ours.imshape,
            )
        )
        return np.asarray(self._lmm.lmm_cube2maps(blurred_t, ours._templates_dev))


@pytest.fixture(scope="module")
def solved_pair():
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    ref_model, ours, fx = _build_flagship_pair()

    # data synthesized by the REFERENCE forward on the ground-truth maps
    maps_true = np.asarray(fx["maps"], np.float64)
    y = np.asarray(ref_model.forward(maps_true), np.float64).ravel()

    # reference pipeline solve (its own inexact-adjoint fixed point)
    x_ref = rh.reference_lcg_solve(
        ref_model, y, MU_SPECTRO, MU_REG, niter=NITER, value_init=0.5
    )
    # ours with the reference's adjoint semantics — the literal A/B
    x_ours_refadj = rh.reference_lcg_solve(
        _OursReferenceAdjointShim(ours), y, MU_SPECTRO, MU_REG,
        niter=NITER, value_init=0.5,
    )
    # our production solve (exact transpose, on-device CG)
    crit = QuadCriterion_MRS(MU_SPECTRO, y, ours, MU_REG, gradient="separated")
    res = crit.run_method("lcg", maximum_iterations=NITER, tolerance=1e-15,
                          value_init=0.5)
    x_ours_exact = np.asarray(res.x, np.float64)
    return ref_model, ours, crit, y, x_ref, x_ours_refadj, x_ours_exact


def test_reconstruction_f32_agreement(solved_pair):
    """North-star wording (BASELINE.md): 'match the reference NumPy/udft
    results to float32 tolerance' — for the full 100-iteration
    reconstruction through criterion+solver, not just one operator
    application.  Measured agreement ~4e-13 relative; asserted at the
    float32-class 1e-6 bar."""
    _, _, _, _, x_ref, x_ours_refadj, _ = solved_pair
    scale = np.abs(x_ref).max()
    np.testing.assert_allclose(x_ours_refadj, x_ref, rtol=0, atol=1e-6 * scale)


def test_criterion_value_parity(solved_pair):
    """The scalar criterion J(x) agrees between the reference's
    get_crit_val (fusion_CT.py:242-265) and ours on the same iterate —
    a direct check of the µ_spectro/µ_reg/½ scaling conventions."""
    ref_model, _, crit, y, x_ref, _, _ = solved_pair
    j_ref = rh.reference_crit_val(ref_model, x_ref, y, MU_SPECTRO, MU_REG)
    j_ours = crit.get_crit_val(x_ref)
    assert j_ref > 0
    np.testing.assert_allclose(j_ours, j_ref, rtol=1e-5)


def test_exact_adjoint_beats_reference_criterion(solved_pair):
    """Our production solve (exact transpose) reaches a strictly lower
    value of the reference's OWN criterion than the reference pipeline
    does (measured 898.7 vs 901.0 at this config): the reference's
    fill-0 reverse-interpolation adjoint is not the transpose of its
    clamped-extrapolation forward, so its CG stalls ~1% from the true
    minimizer.  The resulting maps gap is bounded here so a regression
    in either direction (our solve degrading, or the gap silently
    vanishing because an adjoint was swapped) is caught."""
    ref_model, _, _, y, x_ref, _, x_ours_exact = solved_pair
    j_ref = rh.reference_crit_val(ref_model, x_ref, y, MU_SPECTRO, MU_REG)
    j_exact = rh.reference_crit_val(
        ref_model, x_ours_exact, y, MU_SPECTRO, MU_REG
    )
    assert j_exact < j_ref
    scale = np.abs(x_ref).max()
    gap = np.abs(x_ours_exact - x_ref).max() / scale
    assert 1e-4 < gap < 0.05  # the physical inexact-adjoint gap, ~1.5%


def test_solves_actually_converged(solved_pair):
    """Guard that the A/B compared *converged* solves, not two initial
    guesses: the criterion at the solution is far below the criterion at
    the 0.5-constant init."""
    ref_model, _, _, y, x_ref, _, _ = solved_pair
    j_init = rh.reference_crit_val(
        ref_model, np.full_like(x_ref, 0.5), y, MU_SPECTRO, MU_REG
    )
    j_ref = rh.reference_crit_val(ref_model, x_ref, y, MU_SPECTRO, MU_REG)
    assert j_ref < 0.01 * j_init
