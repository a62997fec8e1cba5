"""Kernel accuracy tests: JAX kernels vs plain NumPy references.

Port of the reference's backend-equivalence strategy
(/root/reference/test/test_accel_accuracy.py): every production kernel is
cross-checked against an independent NumPy formulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.core import bilinear, fft, lmm, wblur


class TestLMM:
    def test_maps2cube_matches_numpy(self, rng):
        maps = rng.random((4, 31, 29))
        tpl = rng.random((4, 57))
        got = np.asarray(lmm.lmm_maps2cube(maps, tpl))
        want = np.sum(maps[:, None] * tpl[..., None, None], axis=0)
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_cube2maps_is_adjoint(self, rng):
        maps = rng.random((4, 31, 29))
        tpl = rng.random((4, 57))
        cube = rng.random((57, 31, 29))
        lhs = np.vdot(np.asarray(lmm.lmm_maps2cube(maps, tpl)), cube)
        rhs = np.vdot(maps, np.asarray(lmm.lmm_cube2maps(cube, tpl)))
        assert abs(lhs - rhs) / abs(lhs) < 1e-12


class TestFFT:
    def test_unitary_roundtrip(self, rng):
        x = rng.random((5, 24, 17))
        y = fft.idft(fft.dft(x), (24, 17))
        np.testing.assert_allclose(np.asarray(y), x, atol=1e-12)

    def test_dft_is_unitary(self, rng):
        x = rng.random((24, 18))
        X = np.asarray(fft.dft(x))
        # Parseval with rfft Hermitian double-count correction
        w = np.full(X.shape, 2.0)
        w[:, 0] = 1
        if x.shape[-1] % 2 == 0:
            w[:, -1] = 1
        np.testing.assert_allclose(np.sum(w * np.abs(X) ** 2), np.sum(x**2), rtol=1e-12)

    def test_ir2fr_convolution_equals_direct_circular(self, rng):
        im = rng.random((16, 16))
        ir = rng.random((5, 5))
        otf = fft.ir2fr(ir, (16, 16))
        got = np.asarray(fft.convolve_freq(im[None], jnp.asarray(otf), (16, 16)))[0]
        # direct circular convolution with centered kernel
        want = np.zeros_like(im)
        for di in range(-2, 3):
            for dj in range(-2, 3):
                want += ir[di + 2, dj + 2] * np.roll(im, (di, dj), axis=(0, 1))
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_half_srf_shift_is_pure_phase(self):
        otf = fft.half_srf_shift_otf(3, (12, 10), dtype=np.complex128)
        np.testing.assert_allclose(np.abs(otf), 1.0, atol=1e-12)


class TestWblur:
    def test_wblur_matches_numpy(self, rng):
        arr = rng.random((40, 9, 7))
        wpsf = rng.random((23, 40, 7))
        got = np.asarray(wblur.wblur(arr, wpsf))
        want = np.sum(arr[None] * wpsf[:, :, None, :], axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_wblur_t_is_adjoint(self, rng):
        arr = rng.random((40, 9, 7))
        wpsf = rng.random((23, 40, 7))
        y = rng.random((23, 9, 7))
        lhs = np.vdot(np.asarray(wblur.wblur(arr, wpsf)), y)
        rhs = np.vdot(arr, np.asarray(wblur.wblur_t(y, wpsf)))
        assert abs(lhs - rhs) / abs(lhs) < 1e-12

    def test_sum_beta_matches_expanded(self, rng):
        arr = rng.random((40, 9, 7))
        wpsf = rng.random((23, 40, 7))
        got = np.asarray(wblur.wblur_sum_beta(arr, wpsf))
        want = np.sum(np.sum(arr[None] * wpsf[:, :, None, :], axis=1), axis=2)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_batched_matches_loop(self, rng):
        arr = rng.random((5, 40, 9, 7))
        wpsf = rng.random((23, 40, 7))
        got = np.asarray(wblur.wblur_sum_beta_batched(arr, wpsf))
        for s in range(5):
            np.testing.assert_allclose(
                got[s], np.asarray(wblur.wblur_sum_beta(arr[s], wpsf)), rtol=1e-10
            )


class TestBilinear:
    def test_matches_scipy_regular_grid(self, rng):
        from scipy.interpolate import RegularGridInterpolator

        ax = np.linspace(0, 1, 21)
        bx = np.linspace(-1, 1, 17)
        cube = rng.random((6, 21, 17))
        pts = np.column_stack([rng.uniform(0, 1, 200), rng.uniform(-1, 1, 200)])
        plan = bilinear.bilinear_plan(ax, bx, pts)
        got = np.asarray(bilinear.apply_plan(plan.idx, plan.w, cube))
        itp = RegularGridInterpolator((ax, bx), np.moveaxis(cube, 0, -1))
        want = np.moveaxis(itp(pts), -1, 0)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_fill_zero_outside(self, rng):
        ax = np.linspace(0, 1, 11)
        bx = np.linspace(0, 1, 11)
        cube = rng.random((2, 11, 11))
        pts = np.array([[0.5, 0.5], [1.5, 0.5], [-0.1, 0.2], [0.2, 1.01]])
        plan = bilinear.bilinear_plan(ax, bx, pts, fill_out_of_bounds=True)
        got = np.asarray(bilinear.apply_plan(plan.idx, plan.w, cube))
        assert np.all(got[:, 1:] == 0)
        assert np.all(got[:, 0] != 0)

    def test_scatter_is_exact_adjoint(self, rng):
        ax = np.linspace(0, 1, 15)
        bx = np.linspace(0, 2, 12)
        cube = rng.random((3, 15, 12))
        pts = np.column_stack([rng.uniform(0, 1, 77), rng.uniform(0, 2, 77)])
        plan = bilinear.bilinear_plan(ax, bx, pts)
        y = rng.random((3, 77))
        fwd = np.asarray(bilinear.apply_plan(plan.idx, plan.w, cube))
        adj = np.asarray(bilinear.scatter_plan(plan.idx, plan.w, y, plan.shape))
        lhs = np.vdot(fwd, y)
        rhs = np.vdot(cube, adj)
        assert abs(lhs - rhs) / abs(lhs) < 1e-12

    def test_extrapolation_outside(self, rng):
        # extrapolate=1 semantics: linear extrapolation beyond the grid
        ax = np.arange(5.0)
        bx = np.arange(4.0)
        plane = ax[:, None] + 2 * bx[None, :]
        pts = np.array([[6.0, 1.0], [-1.0, 2.0]])
        plan = bilinear.bilinear_plan(ax, bx, pts)
        got = np.asarray(bilinear.apply_plan(plan.idx, plan.w, plane[None]))[0]
        np.testing.assert_allclose(got, [6 + 2, -1 + 4], rtol=1e-12)


def test_conv_otf_matmul_matches_fft():
    """Matmul-form DFT convolution == rfft2/irfft2 convolution, and its
    hand transpose == jax.linear_transpose, at machine precision in f64
    (odd/even/non-square grids; the flagship GPU conv backend)."""
    import jax

    from surfh_tpu.core import fft

    rng = np.random.default_rng(0)
    for na, nb in [(21, 21), (20, 24), (17, 16)]:
        W = 4
        x = jnp.asarray(rng.random((W, na, nb)))
        otf = rng.random((W, na, nb // 2 + 1)) + 1j * rng.random(
            (W, na, nb // 2 + 1))
        m = fft.dft_matmul_tables((na, nb), np.float64)
        o_re, o_im = jnp.asarray(otf.real), jnp.asarray(otf.imag)
        ref = np.fft.irfft2(np.fft.rfft2(np.asarray(x)) * otf, s=(na, nb))
        out = fft.conv_otf_matmul(x, o_re, o_im, m)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        f = lambda v: fft.conv_otf_matmul(v, o_re, o_im, m)
        t = jax.linear_transpose(f, jax.ShapeDtypeStruct(x.shape, x.dtype))
        g = jnp.asarray(rng.random(x.shape))
        a = np.asarray(t(g)[0])
        b = np.asarray(fft.conv_otf_matmul_t(g, o_re, o_im, m))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())


def test_spectro_conv_impl_matmul_equivalent():
    """conv_impl='matmul' model == conv_impl='fft' model in float64 (forward,
    adjoint, dot-test) — the GPU default backend's exactness contract."""
    import jax.numpy as jnp2

    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.simulation.synthetic import make_setup

    fx = make_setup(im_size=31, n_lambda=16, n_tpl=3, n_channels=1,
                    n_pointings=2, n_slit=3)
    args = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
            fx["wavelength_axis"], fx["instrs"], fx["step_degree"],
            fx["pointings"])
    A = SpectroSigRLSCT(*args, dtype=jnp2.float64, window_local=True,
                        conv_impl="fft")
    B = SpectroSigRLSCT(*args, dtype=jnp2.float64, window_local=True,
                        conv_impl="matmul")
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random(A.ishape))
    ya, yb = np.asarray(A.forward(x)), np.asarray(B.forward(x))
    np.testing.assert_allclose(yb, ya, rtol=0, atol=1e-12 * np.abs(ya).max())
    yr = jnp.asarray(rng.standard_normal(A.oshape))
    lhs = float(jnp.vdot(B.forward(x), yr))
    rhs = float(jnp.vdot(x, B.adjoint(yr)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_spectro_conv_precision_knob():
    """conv_precision='high' (reduced-precision operands) keeps the exact
    forward/transpose contract (dot-test) — both directions use the same
    precision — and is a numerical no-op in float64 on CPU."""
    import jax.numpy as jnp2

    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.simulation.synthetic import make_setup

    fx = make_setup(im_size=31, n_lambda=16, n_tpl=3, n_channels=1,
                    n_pointings=2, n_slit=3)
    args = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
            fx["wavelength_axis"], fx["instrs"], fx["step_degree"],
            fx["pointings"])
    A = SpectroSigRLSCT(*args, dtype=jnp2.float64, window_local=True,
                        conv_impl="matmul")
    B = SpectroSigRLSCT(*args, dtype=jnp2.float64, window_local=True,
                        conv_impl="matmul", conv_precision="high")
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random(A.ishape))
    np.testing.assert_array_equal(np.asarray(B.forward(x)),
                                  np.asarray(A.forward(x)))
    yr = jnp.asarray(rng.standard_normal(A.oshape))
    lhs = float(jnp.vdot(B.forward(x), yr))
    rhs = float(jnp.vdot(x, B.adjoint(yr)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12
    with np.testing.assert_raises(ValueError):
        SpectroSigRLSCT(*args, conv_precision="fast")


def test_lmm_conv_otf_matmul_fused_exact():
    """Fused T·C (per-map DFT + Fourier-domain LMM) == lmm_maps2cube followed
    by conv_otf_matmul at machine precision in f64, and the hand transpose ==
    jax.linear_transpose — the flagship forward's conv backend."""
    import jax

    from surfh_tpu.core import fft, lmm

    rng = np.random.default_rng(3)
    na, nb, W, M = 21, 24, 6, 3
    maps = jnp.asarray(rng.random((M, na, nb)))
    tpl = jnp.asarray(rng.random((M, W)))
    otf = rng.random((W, na, nb // 2 + 1)) + 1j * rng.random((W, na, nb // 2 + 1))
    o_re, o_im = jnp.asarray(otf.real), jnp.asarray(otf.imag)
    m = fft.dft_matmul_tables((na, nb), np.float64)
    ref = np.asarray(
        fft.conv_otf_matmul(lmm.lmm_maps2cube(maps, tpl), o_re, o_im, m)
    )
    out = np.asarray(fft.lmm_conv_otf_matmul(maps, tpl, o_re, o_im, m))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    f = lambda v: fft.lmm_conv_otf_matmul(v, tpl, o_re, o_im, m)
    t = jax.linear_transpose(f, jax.ShapeDtypeStruct(maps.shape, maps.dtype))
    g = jnp.asarray(rng.random((W, na, nb)))
    a = np.asarray(t(g)[0])
    b = np.asarray(fft.lmm_conv_otf_matmul_t(g, tpl, o_re, o_im, m))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())


def test_conv_freq_truncation_bound_and_adjoint():
    """Frequency-truncated conv: deviation from the full conv is bounded by
    the dropped OTF magnitude, and the truncated pair stays an exact
    forward/transpose couple (dot-test at machine precision)."""
    from surfh_tpu.core import fft

    rng = np.random.default_rng(5)
    na, nb, W = 33, 32, 5
    # band-limited OTF: gaussian decay in both frequency axes
    fa = np.minimum(np.arange(na), na - np.arange(na)) / na
    fb = np.arange(nb // 2 + 1) / nb
    mag = np.exp(-((fa[:, None] / 0.08) ** 2 + (fb[None, :] / 0.08) ** 2))
    otf = mag[None] * np.exp(1j * rng.uniform(0, 2 * np.pi, (W, na, nb // 2 + 1)))
    rtol = 1e-5
    ka_max, kb_keep, dropped = fft.otf_freq_support(otf, rtol)
    assert 0 < ka_max < na // 2 and 0 < kb_keep < nb // 2 + 1
    assert dropped < rtol * 1.5
    sel_a = fft.freq_sel_alpha(na, ka_max)
    m_full = fft.dft_matmul_tables((na, nb), np.float64)
    m_tr = fft.dft_matmul_tables((na, nb), np.float64, ka_max=ka_max, kb_keep=kb_keep)
    x = jnp.asarray(rng.random((W, na, nb)))
    o_re, o_im = jnp.asarray(otf.real), jnp.asarray(otf.imag)
    full = np.asarray(fft.conv_otf_matmul(x, o_re, o_im, m_full))
    otf_tr = otf[:, sel_a, :kb_keep]
    t_re, t_im = jnp.asarray(otf_tr.real), jnp.asarray(otf_tr.imag)
    tr = np.asarray(fft.conv_otf_matmul(x, t_re, t_im, m_tr))
    # operator-norm bound: |Δy| <= dropped·max|otf| · ||x||_2 per plane
    assert np.abs(tr - full).max() <= dropped * mag.max() * float(
        jnp.linalg.norm(x[0].ravel())
    ) * W
    # exact transpose of the truncated forward
    g = jnp.asarray(rng.random((W, na, nb)))
    lhs = float(jnp.vdot(fft.conv_otf_matmul(x, t_re, t_im, m_tr), g))
    rhs = float(jnp.vdot(x, fft.conv_otf_matmul_t(g, t_re, t_im, m_tr)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_spectro_conv_freq_rtol_model():
    """Window-local model with conv_freq_rtol: float32-class deviation from
    the exact-FFT model, exact dot-test, and recorded per-channel supports."""
    import jax.numpy as jnp2

    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.simulation.synthetic import make_setup

    fx = make_setup(im_size=31, n_lambda=16, n_tpl=3, n_channels=2,
                    n_pointings=2, n_slit=3)
    args = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
            fx["wavelength_axis"], fx["instrs"], fx["step_degree"],
            fx["pointings"])
    A = SpectroSigRLSCT(*args, dtype=jnp2.float64, window_local=True,
                        conv_impl="fft")
    B = SpectroSigRLSCT(*args, dtype=jnp2.float64, window_local=True,
                        conv_impl="matmul", conv_freq_rtol=1e-6)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random(A.ishape))
    ya, yb = np.asarray(A.forward(x)), np.asarray(B.forward(x))
    assert B.conv_supports is not None and len(B.conv_supports) == 2
    for sup in B.conv_supports:
        assert sup["keep_frac"] < 1.0
        assert sup["dropped_rel"] <= 1e-6 * 2
    np.testing.assert_allclose(yb, ya, rtol=0, atol=1e-7 * np.abs(ya).max())
    yr = jnp.asarray(rng.standard_normal(A.oshape))
    lhs = float(jnp.vdot(B.forward(x), yr))
    rhs = float(jnp.vdot(x, B.adjoint(yr)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_psf_stamp_otf_matches_ir2fr():
    """otf_from_stamps == ir2fr(psf, grid) sampled at the kept bins, at
    machine precision in f64 — the closed-form the stamp mode relies on."""
    from surfh_tpu.core import fft

    rng = np.random.default_rng(11)
    na, nb, W, sx, sy = 33, 31, 3, 8, 7
    psf = rng.random((W, sx, sy))
    ref = fft.ir2fr(psf, (na, nb))  # [W, na, nb//2+1]
    ka_max, kb_keep = 9, 6
    sel_a = fft.freq_sel_alpha(na, ka_max)
    st = fft.psf_stamp_tables((na, nb), (sx, sy), np.float64,
                              ka_max=ka_max, kb_keep=kb_keep)
    o_re, o_im = fft.otf_from_stamps(jnp.asarray(psf), st)
    want = ref[:, sel_a, :kb_keep]
    np.testing.assert_allclose(np.asarray(o_re), want.real, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(np.asarray(o_im), want.imag, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # support finder agrees with the materialized-OTF one
    got = fft.otf_support_from_psf(psf, (na, nb), 1e-3)
    want_sup = fft.otf_freq_support(ref, 1e-3)
    assert got == want_sup


def test_spectro_psf_stack_mode():
    """psf_stack-only model (OTF evaluated in-graph) == the sotf-table model
    to f32-class tolerance (the cached sotf is complex64), with an exact
    dot-test — the flagship startup path that ships 40×40 stamps instead of
    ~GB OTF windows."""
    import jax.numpy as jnp2

    from surfh_tpu.models.spectro import SpectroSigRLSCT
    from surfh_tpu.simulation.flagship import make_flagship_setup

    fx = make_flagship_setup(npix=41, bands=["4c"], n_pointings=2,
                             lambda_subsample=60, build_sotf=True)
    common = (fx["templates"], fx["alpha_axis"], fx["beta_axis"],
              fx["wavelength_axis"], fx["instrs"], fx["step_degree"],
              fx["pointings"])
    A = SpectroSigRLSCT(fx["sotf"], *common, dtype=jnp2.float64,
                        window_local=True, conv_impl="matmul",
                        conv_freq_rtol=1e-6)
    B = SpectroSigRLSCT(None, *common, dtype=jnp2.float64,
                        window_local=True, conv_impl="matmul",
                        conv_freq_rtol=1e-6, psf_stack=fx["psf_stack"])
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.random(A.ishape))
    ya, yb = np.asarray(A.forward(x)), np.asarray(B.forward(x))
    np.testing.assert_allclose(yb, ya, rtol=0, atol=3e-6 * np.abs(ya).max())
    yr = jnp.asarray(rng.standard_normal(A.oshape))
    lhs = float(jnp.vdot(B.forward(x), yr))
    rhs = float(jnp.vdot(x, B.adjoint(yr)))
    rel_b = abs(lhs - rhs) / abs(lhs)
    # the sotf-table model shows the same ~1.3e-10 on this fixture (vdot
    # summation error at this reduction size, not an adjoint defect) — pin
    # stamp mode to the same order rather than an absolute machine-eps bar
    lhs_a = float(jnp.vdot(A.forward(x), yr))
    rhs_a = float(jnp.vdot(x, A.adjoint(yr)))
    rel_a = abs(lhs_a - rhs_a) / abs(lhs_a)
    assert rel_b < max(3.0 * rel_a, 1e-12)
    import pytest

    with pytest.raises(RuntimeError):
        B.adjoint_fn_const(np.asarray(yr))


def test_lmm_conv_rank_pair_and_equivalence():
    """The rank-basis conv (fft.lmm_conv_rank): (a) mixing its M·R basis
    planes with c[w,(m,r)] = tpl[m,w]·U[w,r] reproduces lmm_conv_otf_matmul
    with the recomposed OTF Σ_r U[:,r]·otf_r at machine precision in f64;
    (b) lmm_conv_rank_t equals jax.linear_transpose; (c) the pair dot-tests
    exactly.  Rank truncation therefore modifies only the *operator* (the
    effective PSF), never the adjoint consistency — the CG-safety contract."""
    import jax

    rng = np.random.default_rng(42)
    M, W, R = 3, 40, 5
    na, nb = 33, 29
    bbox = (4, 3, 17, 15)
    m = fft.dft_matmul_tables((na, nb), np.float64, ka_max=9, kb_keep=8,
                              bbox=bbox)
    md = {k: jnp.asarray(v) for k, v in m.items()}
    ka = len(fft.freq_sel_alpha(na, 9))
    maps = jnp.asarray(rng.standard_normal((M, na, nb)))
    tpl_w = rng.standard_normal((M, W))
    u = rng.standard_normal((W, R))
    o_re = jnp.asarray(rng.standard_normal((R, ka, 8)))
    o_im = jnp.asarray(rng.standard_normal((R, ka, 8)))

    dense = fft.lmm_conv_otf_matmul(
        maps, jnp.asarray(tpl_w),
        jnp.asarray(np.einsum("wr,rck->wck", u, o_re)),
        jnp.asarray(np.einsum("wr,rck->wck", u, o_im)), md)
    y_rank = fft.lmm_conv_rank(maps, o_re, o_im, md)
    c = np.einsum("mw,wr->wmr", tpl_w, u).reshape(W, M * R)
    mixed = jnp.einsum("qab,wq->wab", y_rank, jnp.asarray(c))
    np.testing.assert_allclose(np.asarray(mixed), np.asarray(dense),
                               rtol=0, atol=1e-12 * np.abs(dense).max())

    g = jnp.asarray(rng.standard_normal(y_rank.shape))
    gt = fft.lmm_conv_rank_t(g, o_re, o_im, md, M)
    lt = jax.linear_transpose(
        lambda x: fft.lmm_conv_rank(x, o_re, o_im, md), maps)(g)[0]
    np.testing.assert_allclose(np.asarray(gt), np.asarray(lt),
                               rtol=0, atol=1e-12 * np.abs(lt).max())
    lhs = float(jnp.vdot(y_rank, g))
    rhs = float(jnp.vdot(maps, gt))
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


def test_lowrank_stamp_factor_bound():
    """SVD factorization contract: psf ≈ U·V with the recomposition error
    bounded by the returned tail (σ_{R+1}/σ₁, operator norm ≤ Frobenius
    scale), full rank at rtol=0, and R=1 floor."""
    from surfh_tpu.utils.psf import gaussian_psf

    wl = np.linspace(7.5, 8.8, 200)
    psf = gaussian_psf(wl, 0.04).astype(np.float64)
    u, v, tail = fft.lowrank_stamp_factor(psf, 1e-6)
    assert u.shape[0] == 200 and v.shape[0] == u.shape[1] < 30
    rec = np.einsum("wr,rxy->wxy", u, v)
    s1 = np.linalg.svd(psf.reshape(200, -1), compute_uv=False)[0]
    err = np.linalg.svd((psf - rec).reshape(200, -1), compute_uv=False)[0]
    assert err <= max(tail, 1e-15) * s1 * 1.001
    u0, v0, t0 = fft.lowrank_stamp_factor(psf, 0.0)
    assert t0 == 0.0 or t0 < 1e-14
    u1, v1, _ = fft.lowrank_stamp_factor(psf, 1.0)
    assert v1.shape[0] == 1


def test_gemm_precision_policy():
    """core/precision.py contract: default is full-f32 ("highest"),
    SURFH_GEMM_PRECISION overrides at trace time, invalid values are loud.
    The policy is read by every accuracy-relevant contraction (wblur, lmm,
    solver vdots, ...) because an f32 matmul that names no precision may
    run in TF32 on the GPU."""
    import os

    import pytest

    from surfh_tpu.core.precision import gemm_precision

    old = os.environ.pop("SURFH_GEMM_PRECISION", None)
    try:
        assert gemm_precision() == "highest"
        os.environ["SURFH_GEMM_PRECISION"] = "high"
        assert gemm_precision() == "high"
        os.environ["SURFH_GEMM_PRECISION"] = "bogus"
        with pytest.raises(ValueError):
            gemm_precision()
    finally:
        if old is None:
            os.environ.pop("SURFH_GEMM_PRECISION", None)
        else:
            os.environ["SURFH_GEMM_PRECISION"] = old
