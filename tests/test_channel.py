"""Channel + flagship operator tests: shapes, dottests, parity of tables."""

import numpy as np
import pytest

import fixtures
from surfh_tpu.core.linop import dottest
from surfh_tpu.instrument.geometry import CoordList, get_srf
from surfh_tpu.models.channel import Channel
from surfh_tpu.models.spectro import SpectroSigRLSCT

import jax.numpy as jnp


@pytest.fixture(scope="module")
def fx():
    return fixtures.make()


@pytest.fixture(scope="module")
def channel(fx):
    srf = get_srf([fx["ifu"].det_pix_size], fixtures.STEP_ARCSEC)[0]
    return Channel(
        fx["ifu"],
        fx["alpha_axis"],
        fx["beta_axis"],
        fx["wavelength_axis"],
        srf,
        fx["pointings"],
        fx["step_degree"],
        dtype=jnp.float64,
    )


class TestChannel:
    def test_shapes(self, channel, fx):
        P, S, L, A = channel.oshape
        assert P == len(fx["pointings"])
        assert S == fx["ifu"].n_slit
        assert L == len(fx["chan_wavelength_axis"])
        assert A == channel.slicer.slices_shape[1]

    def test_forward_finite(self, channel, fx, rng):
        cube = rng.random(channel.ishape)
        y = np.asarray(channel.forward(cube))
        assert y.shape == channel.oshape
        assert np.isfinite(y).all()
        assert np.abs(y).max() > 0

    def test_exact_adjoint(self, channel, rng):
        x = rng.standard_normal(channel.ishape)
        y = rng.standard_normal(channel.oshape)
        lhs = np.vdot(np.asarray(channel.forward(x)), y)
        rhs = np.vdot(x, np.asarray(channel.adjoint(y)))
        assert abs(lhs - rhs) / abs(lhs) < 1e-10

    def test_adjoint_interp_close_to_exact(self, channel, rng):
        """The reference's reverse-interp adjoint is approximate; it should be
        *close* to the exact transpose restricted to the λ window."""
        y = rng.standard_normal(channel.oshape)
        approx = np.asarray(channel.adjoint_interp(y))
        exact = np.asarray(channel.adjoint(y))[channel.wslice]
        num = np.linalg.norm(approx - exact)
        den = np.linalg.norm(exact)
        assert num / den < 0.5  # same operator up to interpolation asymmetry

    def test_forward_matches_reference_algorithm(self, channel, fx, rng):
        """Cross-check the fused JAX pipeline against a direct NumPy transcription
        of the reference forward semantics (gridding → FFT SRF sum → slicing →
        wblur_subSampling → α subsample)."""
        cube = rng.random(channel.ishape)
        got = np.asarray(channel.forward(cube))

        xw = cube[channel.wslice]
        W = xw.shape[0]
        nla, nlb = channel.local_im_shape
        n_aout = channel.oshape[3]
        want = np.zeros(channel.oshape)
        for p_idx, plan in enumerate(channel.plans_fwd):
            flat = xw.reshape(W, -1)
            gridded = np.zeros((W, plan.npoints))
            for c in range(4):
                gridded += plan.w[c] * flat[:, plan.idx[c]]
            gridded = gridded.reshape(W, nla, nlb)
            otf = np.asarray(channel.otf_combined)
            summed = np.fft.irfftn(
                np.fft.rfftn(gridded, axes=(-2, -1), norm="ortho") * otf,
                s=(nla, nlb),
                axes=(-2, -1),
                norm="ortho",
            )
            for s in range(channel.instr.n_slit):
                sliced = channel.slicer.slicing(summed, s)
                blurred = np.einsum("lab,klb->ka", sliced, channel.wpsf)
                want[p_idx, s] = blurred[:, : n_aout * channel.srf : channel.srf]
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


class TestSpectro:
    @pytest.fixture(scope="class")
    def model(self, fx):
        return SpectroSigRLSCT(
            fx["sotf"],
            fx["templates"],
            fx["alpha_axis"],
            fx["beta_axis"],
            fx["wavelength_axis"],
            [fx["ifu"]],
            fx["step_degree"],
            [fx["pointings"]],
            dtype=jnp.float64,
        )

    def test_dottest(self, model):
        assert dottest(model, num=3, rtol=1e-10)

    def test_forward_shape(self, model, fx, rng):
        maps = rng.random(model.ishape)
        y = np.asarray(model.forward(maps))
        assert y.shape == model.oshape
        blocks = model.split(y)
        assert blocks[0].shape == model.instrs_oshape[0]
        np.testing.assert_allclose(model.concat(blocks), y)

    def test_cube_mode(self, fx, rng):
        model = SpectroSigRLSCT(
            fx["sotf"],
            None,
            fx["alpha_axis"],
            fx["beta_axis"],
            fx["wavelength_axis"],
            [fx["ifu"]],
            fx["step_degree"],
            [fx["pointings"]],
            dtype=jnp.float64,
        )
        assert model.ishape == (
            len(fx["wavelength_axis"]),
            len(fx["alpha_axis"]),
            len(fx["beta_axis"]),
        )
        assert dottest(model, num=2, rtol=1e-10)

    def test_two_channels(self, fx, rng):
        """Heterogeneous channels concatenate correctly."""
        from surfh_tpu.instrument.ifu import IFU
        from surfh_tpu.instrument.geometry import FOV, Coord

        ifu2 = IFU(
            fov=FOV(
                fx["ifu"].fov.alpha_width * 1.2,
                fx["ifu"].fov.beta_width * 0.9,
                origin=Coord(0, 0),
                angle=7.7,
            ),
            det_pix_size=0.245,
            n_slit=4,
            w_blur=fx["spec_blur"],
            pce=None,
            wavel_axis=fx["chan_wavelength_axis"][30:],
            name="3A",
        )
        model = SpectroSigRLSCT(
            fx["sotf"],
            fx["templates"],
            fx["alpha_axis"],
            fx["beta_axis"],
            fx["wavelength_axis"],
            [fx["ifu"], ifu2],
            fx["step_degree"],
            [fx["pointings"], fx["pointings"]],
            dtype=jnp.float64,
        )
        maps = rng.random(model.ishape)
        y = np.asarray(model.forward(maps))
        assert y.shape == model.oshape
        assert dottest(model, num=2, rtol=1e-10)
