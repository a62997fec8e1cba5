"""Solver tests: CG/MM-MG correctness and the end-to-end 2-D deconvolution slice.

The end-to-end test is BASELINE config 1 in miniature: simulate detector data
through the rectangle 2-D model, reconstruct with the quadratic criterion, and
check convergence to the ground truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import fixtures
from surfh_tpu.core.linop import dottest
from surfh_tpu.instrument.geometry import FOV, Coord, CoordList
from surfh_tpu.instrument.ifu import IFU
from surfh_tpu.models.blind2d import MRSBlurred, MRSBlurredRectangle
from surfh_tpu.solvers.cg import lcg, mmmg
from surfh_tpu.solvers.criterion import QuadCriterion_MRS, QuadCriterion_MRS_2D
from surfh_tpu.core.fft import ir2fr


class TestCG:
    def _spd(self, rng, n=24):
        A = rng.standard_normal((n, n))
        Q = A @ A.T + n * np.eye(n)
        b = rng.standard_normal(n)
        return Q, b

    def test_lcg_solves(self, rng):
        Q, b = self._spd(rng)
        res = lcg(lambda x: jnp.asarray(Q) @ x, b, np.zeros_like(b), max_iter=200, tol=1e-12)
        np.testing.assert_allclose(res.x, np.linalg.solve(Q, b), rtol=1e-6)
        assert res.converged

    def test_mmmg_solves(self, rng):
        Q, b = self._spd(rng)
        res = mmmg(lambda x: jnp.asarray(Q) @ x, b, np.zeros_like(b), max_iter=300, tol=1e-12)
        np.testing.assert_allclose(res.x, np.linalg.solve(Q, b), rtol=1e-5)

    def test_grad_norm_decreases(self, rng):
        Q, b = self._spd(rng)
        res = lcg(lambda x: jnp.asarray(Q) @ x, b, np.zeros_like(b), max_iter=50, tol=0)
        assert res.grad_norm[-1] < res.grad_norm[0] * 1e-6


def _blind_setup(rectangle=True, im=61, n_slit=4, dtype=jnp.float64):
    rng = np.random.default_rng(7)
    step = fixtures.STEP_DEGREE
    alpha_axis = (np.arange(im) - im // 2) * step
    beta_axis = (np.arange(im) - im // 2) * step
    fov_w = 0.4 * im * fixtures.STEP_ARCSEC
    instr = IFU(
        fov=FOV(fov_w / 3600, 1.1 * fov_w / 3600, origin=Coord(0, 0), angle=0.0 if rectangle else 8.1),
        det_pix_size=0.196,
        n_slit=n_slit,
        w_blur=None,
        pce=None,
        wavel_axis=None,
        name="1C",
    ).pix(step)
    pointings = CoordList([Coord(0, 0), Coord(4 * step, 2 * step), Coord(-3 * step, -2 * step)]).pix(step)
    psf = np.ones((5, 5)) / 25.0
    sotf = ir2fr(psf, (im, im))
    cls = MRSBlurredRectangle if rectangle else MRSBlurred
    model = cls(sotf, alpha_axis, beta_axis, instr, step, pointings, dtype=dtype)
    # smooth ground truth
    xx, yy = np.meshgrid(np.linspace(-1, 1, im), np.linspace(-1, 1, im), indexing="ij")
    truth = np.exp(-(xx**2 + yy**2) / 0.2) + 0.3
    return model, truth, rng


class TestBlind2D:
    def test_rectangle_dottest(self):
        model, _, _ = _blind_setup(rectangle=True)
        assert dottest(model, num=3, rtol=1e-10)

    def test_rotated_dottest(self):
        model, _, _ = _blind_setup(rectangle=False)
        assert dottest(model, num=3, rtol=1e-10)

    def test_end_to_end_deconvolution(self):
        model, truth, rng = _blind_setup(rectangle=True)
        y = np.asarray(model.forward(truth))
        crit = QuadCriterion_MRS_2D(1.0, y, model, mu_reg=1e-6)
        res = crit.run_method("lcg", maximum_iterations=150, tolerance=1e-12, value_init=0.5)
        # inside the observed FOV the reconstruction must approach the truth
        recon = res.x.reshape(model.ishape)
        # coverage mask: adjoint of ones
        cover = np.asarray(model.adjoint(np.ones(model.oshape)))
        mask = cover > 0.5 * cover.max()
        rel = np.linalg.norm((recon - truth)[mask]) / np.linalg.norm(truth[mask])
        assert rel < 0.05, f"relative error {rel:.3f}"

    def test_criterion_decreases(self):
        model, truth, _ = _blind_setup(rectangle=True, im=41, n_slit=3)
        y = np.asarray(model.forward(truth))
        crit = QuadCriterion_MRS_2D(1.0, y, model, mu_reg=1e-5)
        j0 = crit.get_crit_val(np.full(model.ishape, 0.5))
        res = crit.run_method("lcg", maximum_iterations=30)
        j1 = crit.get_crit_val(res.x)
        assert j1 < j0 * 1e-2

    def test_data_to_img_runs(self):
        model, truth, _ = _blind_setup(rectangle=True, im=41, n_slit=3)
        y = np.asarray(model.forward(truth))
        img = model.data_to_img(y)
        assert img.shape == model.imshape
        assert np.isfinite(img).all()


class TestCriterion3D:
    def test_lcg_vs_mmmg_agree(self):
        fx = fixtures.make(im_size=41, n_lambda=20)
        from surfh_tpu.models.spectro import SpectroSigRLSCT

        model = SpectroSigRLSCT(
            fx["sotf"][:20],
            fx["templates"][:, :20] if fx["templates"].shape[1] != 20 else fx["templates"],
            fx["alpha_axis"],
            fx["beta_axis"],
            fx["wavelength_axis"][:20],
            [fx["ifu"]],
            fx["step_degree"],
            [fx["pointings"]],
            dtype=jnp.float64,
        )
        rng = np.random.default_rng(3)
        truth = rng.random(model.ishape)
        y = np.asarray(model.forward(truth))
        crit = QuadCriterion_MRS(1.0, y, model, mu_reg=1e-4)
        res_cg = crit.run_method("lcg", maximum_iterations=40)
        res_mm = crit.run_method("mmmg", maximum_iterations=40)
        j0 = crit.get_crit_val(np.full(model.ishape, 0.5))
        j_cg, j_mm = crit.get_crit_val(res_cg.x), crit.get_crit_val(res_mm.x)
        # MM-MG with exact 2-plane minimization is CG on a quadratic; finite
        # precision on an ill-conditioned Hessian lets them drift a little
        assert j_cg < 1e-3 * j0 and j_mm < 1e-3 * j0
        np.testing.assert_allclose(j_cg, j_mm, rtol=0.25)


class TestDeconvCube:
    """BASELINE config 2: λ-stack no-rotation cube deconvolution
    (reference scripts/deconvolution_mrs_noRotation.py run per λ)."""

    def _cube_setup(self, w=5, im=41, n_slit=3):
        from surfh_tpu.models.blind2d import DeconvCube

        base, truth2d, rng = _blind_setup(rectangle=True, im=im, n_slit=n_slit)
        # per-λ PSFs of differing widths → distinct OTFs per plane
        sotfs = []
        for k in range(w):
            s = 1.0 + 0.4 * k
            ax = np.arange(-4, 5)
            psf = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2 * s * s))
            sotfs.append(ir2fr(psf / psf.sum(), (im, im)))
        model = DeconvCube(base, np.stack(sotfs))
        spectra = 0.5 + np.arange(1, w + 1) / w
        truth = spectra[:, None, None] * truth2d
        return model, base, np.stack(sotfs), truth

    def test_forward_matches_per_plane_2d(self):
        """The vmapped stack forward == one 2-D forward per λ plane."""
        model, base, sotfs, truth = self._cube_setup()
        y = np.asarray(model.forward(truth)).reshape(model.cube_oshape)
        for k in range(model.n_lambda):
            yk = np.asarray(
                base._forward_fn(jnp.asarray(truth[k], base.dtype), jnp.asarray(sotfs[k]))
            ).reshape(base.slices_shape)
            np.testing.assert_allclose(y[k], yk, rtol=1e-12)

    def test_dottest(self):
        model, *_ = self._cube_setup(w=3)
        assert dottest(model, num=3, rtol=1e-10)

    def test_end_to_end_cube_deconvolution(self):
        model, base, _, truth = self._cube_setup()
        y = np.asarray(model.forward(truth))
        crit = QuadCriterion_MRS(1.0, y, model, mu_reg=1e-6, gradient="separated")
        res = crit.run_method("lcg", maximum_iterations=150, tolerance=1e-12, value_init=0.5)
        recon = res.x.reshape(model.ishape)
        cover = np.asarray(base.adjoint(np.ones(base.oshape)))
        mask = cover > 0.5 * cover.max()
        rel = np.linalg.norm(
            (recon - truth)[:, mask]
        ) / np.linalg.norm(truth[:, mask])
        assert rel < 0.05, f"relative error {rel:.3f}"


def test_lcg_dispatch_matches_graph():
    """Dispatch-mode CG (Python-orchestrated per-iteration jitted steps, the
    flagship-scale path where an in-graph while loop OOMs HBM) is
    bit-identical to the lax.while_loop build."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    model, setup = make_model(
        im_size=31, n_lambda=16, n_tpl=3, n_channels=1, n_pointings=1,
        n_slit=3, dtype=jnp.float64,
    )
    y = np.asarray(model.forward(setup["maps"]))
    crit = QuadCriterion_MRS(1.0, y, model, 10.0)
    a = crit.run_method("lcg", maximum_iterations=25)
    b = crit.run_method("lcg", maximum_iterations=25, solver_loop="dispatch")
    assert a.n_iter == b.n_iter
    np.testing.assert_array_equal(a.x, b.x)
    # norm telemetry is fetched as float32 in dispatch mode, so the history
    # matches at f32 precision
    np.testing.assert_allclose(a.grad_norm, b.grad_norm, rtol=1e-6)


def test_mmmg_dispatch_matches_graph():
    """Dispatch-mode mmmg (the flagship-scale path) minimizes the same
    quadratic as the graph build — same iterate sequence modulo f32
    telemetry, and both reach the same criterion value."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    model, setup = make_model(
        im_size=31, n_lambda=16, n_tpl=3, n_channels=1, n_pointings=1,
        n_slit=3, dtype=jnp.float64,
    )
    y = np.asarray(model.forward(setup["maps"]))
    crit = QuadCriterion_MRS(1.0, y, model, 10.0)
    a = crit.run_method("mmmg", maximum_iterations=25)
    b = crit.run_method("mmmg", maximum_iterations=25, solver_loop="dispatch")
    assert a.n_iter == b.n_iter == 25
    np.testing.assert_allclose(b.x, a.x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a.grad_norm, b.grad_norm, rtol=1e-6)


def test_lcg_chained_dispatch_matches_unchained():
    """chain_steps=K unrolls K CG iterations per dispatched program (one
    dispatch per K iterations); the iterate sequence is the same math, so
    results must match the per-iteration dispatch to f32 fusion noise — and
    a non-divisible max_iter must still run EXACTLY max_iter iterations via
    the remainder-length program."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    model, setup = make_model(
        im_size=31, n_lambda=16, n_tpl=3, n_channels=1, n_pointings=1,
        n_slit=3, dtype=jnp.float64,
    )
    y = np.asarray(model.forward(setup["maps"]))
    crit = QuadCriterion_MRS(1.0, y, model, 10.0)
    a = crit.run_method("lcg", maximum_iterations=25, solver_loop="dispatch")
    # 25 % 4 != 0: exercises the remainder program
    b = crit.run_method("lcg", maximum_iterations=25, solver_loop="dispatch",
                        solver_chain=4)
    c = crit.run_method("lcg", maximum_iterations=25, solver_loop="dispatch",
                        solver_chain=25)
    assert a.n_iter == b.n_iter == c.n_iter == 25
    assert len(b.grad_norm) == len(a.grad_norm)
    # XLA may fuse across unrolled bodies, so allow tiny reassociation noise
    np.testing.assert_allclose(a.x, b.x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a.x, c.x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a.grad_norm, b.grad_norm, rtol=1e-5)


def test_lcg_large_mu_float32_conditioning():
    """The reference's real-data deep run uses µ=5e8 in float32
    (fusion_real_data_multi_chan.py:445-461; SURVEY hard part #6 flags f32
    CG conditioning there).  With the precision-pinned solver vdots the
    grad norm must decrease monotonically-in-trend and substantially even
    when the regularizer dominates the Hessian by ~9 orders of magnitude.
    Flagship-scale evidence (500 it, 239x reduction) is in PERF.md; this
    pins the behavior at CI scale in f32."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    model, setup = make_model(
        im_size=31, n_lambda=16, n_tpl=3, n_channels=1, n_pointings=1,
        n_slit=3, dtype=jnp.float32,
    )
    y = np.asarray(model.forward(setup["maps"]))
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg=5e8)
    res = crit.run_method("lcg", maximum_iterations=100)
    gn = np.asarray(res.grad_norm, np.float64)
    assert np.isfinite(gn).all(), "f32 CG produced non-finite grad norms"
    # the grad norm OSCILLATES at this conditioning (CG minimizes the
    # Q-norm of the error, not the residual norm), so assert on the
    # running minimum: measured 4650x at this fixture (1.09e5 -> 23.4);
    # guard a stall, not a rate
    assert gn.min() < gn[0] / 100, (
        f"µ=5e8 f32 CG stalled: {gn[0]:.3e} -> min {gn.min():.3e}"
    )
    half = len(gn) // 2
    assert gn[half:].min() < gn[:half].min(), (
        "no progress in the second half"
    )
