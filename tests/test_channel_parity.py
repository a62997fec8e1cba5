"""Numerical output parity: our Channel vs the reference Channel.

Runs the reference `spectroModelChannel.Channel` (with scipy stand-ins for
its compiled interpolation, semantics-matched) and compares forward outputs
and the reference-style reverse-interpolation adjoint on identical inputs —
the SURVEY hard-part #1 check ("matching the reference's outputs requires
matching these quirks").
"""

import os

import numpy as np
import pytest

import reference_harness as rh
from surfh_tpu.instrument.geometry import Coord, CoordList
from surfh_tpu.models.channel import Channel

pytestmark = pytest.mark.skipif(
    not rh.reference_available(), reason="reference checkout absent"
)


def _build_both():
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_setup

    ref_instru = rh.load_reference_instru()
    ref_mod = rh.load_reference_channel(ref_instru)

    fx = make_setup(im_size=41, n_lambda=30, n_tpl=3, n_channels=1, n_pointings=2, n_slit=3)
    ours_ifu = fx["instrs"][0]
    step = fx["step_degree"]

    # mirror the IFU in the reference's instru types
    ref_ifu = ref_instru.IFU(
        fov=ref_instru.FOV(
            ours_ifu.fov.alpha_width,
            ours_ifu.fov.beta_width,
            origin=ref_instru.Coord(0, 0),
            angle=ours_ifu.fov.angle,
        ),
        det_pix_size=ours_ifu.det_pix_size,
        n_slit=ours_ifu.n_slit,
        w_blur=ref_instru.SpectralBlur(ours_ifu.w_blur.grating_resolution),
        pce=None,
        wavel_axis=np.asarray(ours_ifu.wavel_axis),
        name="2A",
    )
    ref_pts = ref_instru.CoordList(
        [ref_instru.Coord(p.alpha, p.beta) for p in fx["pointings"][0]]
    ).pix(step)
    srf = 7  # fixture det_pix_size 0.196 / step 0.025 (get_srf convention)
    from surfh_tpu.instrument.geometry import get_srf

    srf = get_srf([ours_ifu.det_pix_size], step * 3600)[0]

    ref_chan = ref_mod.Channel(
        ref_ifu, fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"],
        srf, ref_pts, step,
    )
    ours = Channel(
        ours_ifu, fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"],
        srf, CoordList(fx["pointings"][0]), step, dtype=jnp.float64,
    )
    return ref_chan, ours, fx


@pytest.fixture(scope="module")
def channels():
    return _build_both()


def test_channel_shapes_match(channels):
    ref_chan, ours, fx = channels
    assert tuple(ref_chan.oshape) == tuple(ours.oshape)
    assert ref_chan.wslice == ours.wslice


def test_channel_forward_parity(channels):
    """Float64 machine-precision output parity (the BASELINE.md fidelity bar
    is float32 tolerance; measured agreement is ~5e-16 relative)."""
    ref_chan, ours, fx = channels
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(ours.ishape)
    y_ref = np.asarray(ref_chan.forward(cube)).reshape(ours.oshape)
    y_ours = np.asarray(ours.forward(cube))
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y_ours, y_ref, rtol=0, atol=1e-13 * scale)


def test_channel_reference_adjoint_parity(channels):
    """Our `adjoint_interp` mirrors the reference's reverse-interpolation
    adjoint (spectroModelChannel.py:234-264)."""
    ref_chan, ours, fx = channels
    rng = np.random.default_rng(1)
    y = rng.standard_normal(ours.oshape)
    # the reference adjoint returns the λ-window cube, like adjoint_interp
    a_ref = np.asarray(ref_chan.adjoint(y.ravel())).astype(float)
    a_ours = np.asarray(ours.adjoint_interp(y))
    assert a_ours.shape == a_ref.shape
    scale = np.abs(a_ref).max()
    np.testing.assert_allclose(a_ours, a_ref, rtol=0, atol=1e-13 * scale)


def test_slice_to_cube_parity(channels):
    """Dirac-wpsf re-projection parity (reference :266-301).  The reference
    casts the β-oversampled data to float32 inside its wblur_t call, so the
    bar is float32 precision, not float64."""
    ref_chan, ours, fx = channels
    rng = np.random.default_rng(4)
    y = rng.standard_normal(ours.oshape)
    c_ref = np.asarray(ref_chan.sliceToCube(y.ravel()))
    c_ours = np.asarray(ours.sliceToCube(y))
    assert c_ours.shape == c_ref.shape
    scale = np.abs(c_ref).max()
    np.testing.assert_allclose(c_ours, c_ref, rtol=0, atol=1e-6 * scale)


def test_realdata_cube_to_slice_parity(channels):
    ref_chan, ours, fx = channels
    rng = np.random.default_rng(5)
    # the reference writes each slit's β-sum into slices[s] of shape
    # (oshape[2], oshape[3]) — so the input cube's λ axis must be the
    # DETECTOR λ' count, not the global-axis window (reference :304-309)
    cube_w = rng.standard_normal(
        (ours.oshape[2], len(ours.alpha_axis), len(ours.beta_axis))
    )
    s_ref = np.asarray(ref_chan.realData_cubeToSlice(cube_w))
    s_ours = np.asarray(ours.realData_cubeToSlice(cube_w))
    assert s_ours.shape == s_ref.shape
    scale = np.abs(s_ref).max()
    np.testing.assert_allclose(s_ours, s_ref, rtol=0, atol=1e-13 * scale)


def test_realdata_slice_to_cube_parity(channels):
    ref_chan, ours, fx = channels
    rng = np.random.default_rng(6)
    W = ours.n_wslice
    slices = rng.standard_normal((ours.instr.n_slit, W, ours.oshape[3]))
    cube_dim = (W, len(ours.alpha_axis), len(ours.beta_axis))
    c_ref = np.asarray(ref_chan.realData_sliceToCube(slices, cube_dim))
    c_ours = np.asarray(ours.realData_sliceToCube(slices, cube_dim))
    assert c_ours.shape == c_ref.shape
    scale = np.abs(c_ref).max()
    np.testing.assert_allclose(c_ours, c_ref, rtol=0, atol=1e-13 * scale)


@pytest.fixture(scope="module")
def flagship_pair():
    return _build_flagship_pair()


def _build_flagship_pair():
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_setup
    from surfh_tpu.models.spectro import SpectroSigRLSCT

    ref_instru = rh.load_reference_instru()
    ref_spectro = rh.load_reference_spectro(ref_instru)
    if ref_spectro is None:
        pytest.skip("reference flagship not importable")

    fx = make_setup(im_size=41, n_lambda=30, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)

    ref_ifus = [
        ref_instru.IFU(
            fov=ref_instru.FOV(
                i.fov.alpha_width, i.fov.beta_width,
                origin=ref_instru.Coord(0, 0), angle=i.fov.angle,
            ),
            det_pix_size=i.det_pix_size,
            n_slit=i.n_slit,
            w_blur=ref_instru.SpectralBlur(i.w_blur.grating_resolution),
            pce=None,
            wavel_axis=np.asarray(i.wavel_axis),
            name=i.name,
        )
        for i in fx["instrs"]
    ]
    step = fx["step_degree"]
    ref_pts = ref_instru.CoordList(
        [ref_instru.Coord(p.alpha, p.beta) for p in fx["pointings"][0]]
    ).pix(step)

    ref_model = ref_spectro.spectroSigRLSCT(
        fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
        fx["wavelength_axis"], ref_ifus, step, [ref_pts for _ in ref_ifus],
    )
    ours = SpectroSigRLSCT(
        fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"],
        fx["wavelength_axis"], fx["instrs"], step, fx["pointings"],
        dtype=jnp.float64,
    )
    return ref_model, ours, fx


def test_flagship_forward_parity(flagship_pair):
    """Our SpectroSigRLSCT reproduces the reference spectroSigRLSCT forward
    on identical multi-channel inputs (spectroModel.py:158-170)."""
    ref_model, ours, fx = flagship_pair
    # the reference LinOp stub doesn't store oshape; compare the block index
    np.testing.assert_array_equal(ours._idx, ref_model._idx)

    rng = np.random.default_rng(2)
    maps = rng.standard_normal(ours.ishape)
    y_ref = np.asarray(ref_model.forward(maps)).ravel()
    y_ours = np.asarray(ours.forward(maps))
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y_ours, y_ref, rtol=0, atol=1e-13 * scale)


def test_plot_slice_parity(flagship_pair):
    """plot_slice re-projection parity (reference spectroModel.py:242-286) —
    the body shared by make_mask, so mask parity follows transitively."""
    ref_model, ours, fx = flagship_pair
    rng = np.random.default_rng(7)
    all_data = rng.standard_normal(ours.oshape)
    nslice = ours.channels[0].oshape[2] // 2
    wm_ref, gi_ref = ref_model.plot_slice(all_data, 0, nslice)
    wm_ours, gi_ours = ours.plot_slice(all_data, 0, nslice)
    scale = np.abs(gi_ref).max()
    np.testing.assert_allclose(gi_ours, gi_ref, rtol=0, atol=1e-13 * scale)
    # The weighted-mean output is not cross-checkable element-wise: where no
    # pointing's re-projection exceeds the validity threshold, np.divide(...,
    # where=...) without out= leaves UNDEFINED memory — a reference quirk we
    # reproduce verbatim (spectroModel.py:282-284).  The deterministic
    # computation (global_img, and the per-pointing grids feeding the mean)
    # is covered by the assertion above.
    assert wm_ours.shape == wm_ref.shape


def test_make_mask_is_thresholded_plot_slice(flagship_pair):
    """Our make_mask = thresholded plot_slice re-projection per channel group
    (reference spectroModel.py:289-338), tested incl. a band list that is NOT
    a multiple of 3."""
    ref_model, ours, fx = flagship_pair
    rng = np.random.default_rng(8)
    all_data = 100.0 * rng.random(ours.oshape)
    masks = ours.make_mask(all_data, threshold=50.0, nslice=ours.channels[0].oshape[2] // 2)
    leads = ours._mask_group_leads()
    assert len(masks) == len(leads)
    for m, ch in zip(masks, leads):
        _, gi = ours.plot_slice(all_data, ch, ours.channels[0].oshape[2] // 2)
        np.testing.assert_array_equal(m, gi > 50.0)
    # the synthetic 2-channel fixture groups into one triple
    assert leads == [0]


def test_blind2d_forward_parity():
    """Our MRSBlurred (2-D single-λ) matches the reference spectro_blind
    forward (spectro_blind.py:191-207)."""
    from surfh_tpu.core.fft import ir2fr
    from surfh_tpu.models.blind2d import MRSBlurred
    from surfh_tpu.simulation.synthetic import make_setup

    ref_instru = rh.load_reference_instru()
    ref_blind = rh.load_reference_blind(ref_instru)
    if ref_blind is None:
        pytest.skip("reference blind model not importable")

    fx = make_setup(im_size=45, n_lambda=8, n_tpl=2, n_channels=1, n_pointings=2, n_slit=5)
    ours_ifu = fx["instrs"][0]
    step = fx["step_degree"]
    psf0 = fx["spsf"][0]
    sotf = ir2fr(psf0, fx["im_shape"])

    ref_ifu = ref_instru.IFU(
        fov=ref_instru.FOV(
            ours_ifu.fov.alpha_width, ours_ifu.fov.beta_width,
            origin=ref_instru.Coord(0, 0), angle=ours_ifu.fov.angle,
        ),
        det_pix_size=ours_ifu.det_pix_size,
        n_slit=ours_ifu.n_slit,
        w_blur=None,
        pce=None,
        wavel_axis=np.asarray(ours_ifu.wavel_axis),
        name="2A",
    )
    ref_pts = ref_instru.CoordList(
        [ref_instru.Coord(p.alpha, p.beta) for p in fx["pointings"][0]]
    ).pix(step)
    ref_model = ref_blind.MRSBlurred(
        sotf, fx["alpha_axis"], fx["beta_axis"], ref_ifu, step, ref_pts
    )
    import jax.numpy as jnp

    ours = MRSBlurred(
        sotf, fx["alpha_axis"], fx["beta_axis"], ours_ifu, step,
        fx["pointings"][0], dtype=jnp.float64,
    )
    rng = np.random.default_rng(3)
    x = rng.standard_normal(fx["im_shape"])
    y_ref = np.asarray(ref_model.forward(x)).ravel()
    y_ours = np.asarray(ours.forward(x)).ravel()
    assert y_ours.shape == y_ref.shape
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y_ours, y_ref, rtol=0, atol=2e-3 * scale)


def test_channel_parity_real_band_coarse():
    """Default-on REAL-band-table parity: band 4a with
    its actual 542-sample detector λ table at a coarse 0.1″ step on a 61²
    grid — forward AND reverse-interpolation adjoint at machine precision
    vs the reference Channel, in ~8 s.  The full 251²/970-λ fixture-scale
    version stays behind SURFH_SLOW_PARITY below."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from parity_ref_scale import build_pair

    ref_chan, ours = build_pair(
        npix=61, band_name="4a", n_pointings=1, subsample=6, step_arcsec=0.1
    )
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(ours.ishape)
    y_ref = np.asarray(ref_chan.forward(cube))
    y_ours = np.asarray(ours.forward(cube)).reshape(y_ref.shape)
    np.testing.assert_allclose(
        y_ours, y_ref, rtol=0, atol=1e-13 * np.abs(y_ref).max())

    yr = rng.standard_normal(tuple(ref_chan.oshape))
    a_ref = np.asarray(ref_chan.adjoint(yr))
    a_ours = np.asarray(ours.adjoint_interp(yr))
    np.testing.assert_allclose(
        a_ours, a_ref, rtol=0, atol=1e-13 * np.abs(a_ref).max())


# Collection-time gate (not a pytest skip — the default suite stays at
# zero skips): the fixture-scale run costs ~25 min of reference CPU time.
# scripts/parity_ref_scale.py runs the same check standalone.
if os.environ.get("SURFH_SLOW_PARITY"):
    def test_channel_parity_reference_fixture_scale():
       """251² sky grid, real band-2a 970-λ detector table (the scale of
       /root/reference/test/global_variable_testing.py:5-243): forward and
       reverse-interpolation adjoint both at machine precision (measured
       2.2e-15 / 2.3e-15)."""
       import sys

       sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
           os.path.abspath(__file__))), "scripts"))
       from parity_ref_scale import build_pair

       ref_chan, ours = build_pair()
       rng = np.random.default_rng(0)
       cube = rng.standard_normal(ours.ishape)
       y_ref = np.asarray(ref_chan.forward(cube))
       y_ours = np.asarray(ours.forward(cube)).reshape(y_ref.shape)
       np.testing.assert_allclose(
           y_ours, y_ref, rtol=0, atol=1e-13 * np.abs(y_ref).max())

       yr = rng.standard_normal(tuple(ref_chan.oshape))
       a_ref = np.asarray(ref_chan.adjoint(yr))
       a_ours = np.asarray(ours.adjoint_interp(yr))
       np.testing.assert_allclose(
           a_ours, a_ref, rtol=0, atol=1e-13 * np.abs(a_ref).max())
