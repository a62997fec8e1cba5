"""The chained production rehearsal: synthetic stage-2
→ distortion correction → median λ-filter → fusion → flux comparison, as
ONE CLI invocation, asserted end-to-end; plus the sharded-solve cross-check
on the 8-device mesh.

Reference flow: /root/reference/scripts/correction_mrs_data.py:92-199 →
filter_corrected_mrs_data.py:34 → main_fusion.py:215-273 →
compare_mean_flux_fusion_vs_real_data.py.
"""

import json
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    import contextlib
    import io

    from surfh_tpu.cli import main as cli_main

    work = str(tmp_path_factory.mktemp("rehearse"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main([
            "rehearse", "-w", work, "--band", "4a", "--pointings", "2",
            "-np", "101", "--step", "0.1", "--lambda-subsample", "6",
            "-hp", "1.0", "-ni", "50",
        ])
    assert rc == 0
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    return work, rep


def test_rehearsal_chain_outputs(rehearsal):
    work, rep = rehearsal
    # every stage left its artifacts
    raws = [f for f in os.listdir(os.path.join(work, "raw")) if f.endswith(".fits")]
    assert len(raws) == 2
    filt = [f for f in os.listdir(os.path.join(work, "Filtered_slices"))
            if f.endswith(".fits")]
    assert len(filt) == 2
    out = os.path.join(work, "out")
    for f in ("res_x.npy", "res_cube.npy", "criterion.npy", "flux_compare.npz"):
        assert os.path.exists(os.path.join(out, f)), f


def test_rehearsal_reconstruction_quality(rehearsal):
    _work, rep = rehearsal
    # the fused model reproduces the corrected data (measured 3.8% at
    # subsample 4 / 60 iters; bound leaves slack for the coarser test run)
    assert rep["residual_rel"] < 0.10, rep
    # fused-vs-data mean-flux curves agree in shape and scale
    assert 0.9 < rep["flux_ratio_median"] < 1.1, rep
    assert rep["flux_shape_corr"] > 0.9, rep
    assert rep["flux_points"] > 50


def test_rehearsal_sharded_solve_matches(rehearsal):
    """The same rehearsal problem solved over the 8-device channel mesh
    reaches the same solution (multi-chip flow of the production chain)."""
    import jax.numpy as jnp

    from surfh_tpu.core.fft import ir2fr
    from surfh_tpu.parallel.fusion import ShardedSpectro, make_mesh
    from surfh_tpu.pipeline import (
        assemble_data_vector,
        create_instruments,
        create_model,
        crop_psf_stack,
        load_corrected_data,
    )

    work, rep = rehearsal
    band, npix, step = "4a", 101, 0.1 / 3600.0
    tpl = np.load(os.path.join(work, "Templates", "templates.npy"))
    wl = np.load(os.path.join(work, "Templates", "wavel_axis.npy"))
    spsf = crop_psf_stack(np.load(os.path.join(work, "PSF", "psf.npy")), npix)
    alpha = np.arange(npix) * step
    alpha -= alpha.mean()
    sotf = ir2fr(spsf, (npix, npix))
    dd = load_corrected_data(os.path.join(work, "Filtered_slices"), [band])
    instr = create_instruments(dd, [band])
    model = create_model(sotf, tpl, alpha, alpha.copy(), wl, instr, step, dd)
    y = model.real_data_janskySR_to_jansky(
        assemble_data_vector(model, dd, [band])
    )

    sh = ShardedSpectro(model, make_mesh(8))
    # same init as the criterion default (value_init=0.5): with data only
    # constraining the FOV interior, CG leaves the outside at the init
    res = sh.solve(y, mu_reg=1.0, max_iter=50,
                   x0=np.full(model.ishape, 0.5, np.float32))
    x_ref = np.load(os.path.join(work, "out", "res_x.npy"))
    scale = np.abs(x_ref).max()
    np.testing.assert_allclose(
        np.asarray(res.x), x_ref, rtol=0, atol=5e-3 * scale)


def test_rehearse_seeded_from_real_header(tmp_path, capsys):
    """The full correction→fusion chain driven by the GENUINE geometry of
    the vendored PDRs4All cal header: PA_V3 ≈ 68.58°,
    TARG_RA/TARG_DEC of the Orion Bar, band derived from CHANNEL='12' +
    BAND='SHORT' — instead of the synthetic defaults (pa_v3=0)."""
    from surfh_tpu.cli import main as cli_main
    from surfh_tpu.preprocessing.metadata import header_geometry

    fixture = os.path.join(
        os.path.dirname(__file__), "fixtures", "miri_mrs_cal_header.txt"
    )
    geo = header_geometry(fixture)
    assert geo["band"] == "1a"  # CHANNEL='12' first digit + BAND='SHORT'
    assert geo["targ_ra"] == pytest.approx(83.8354047)
    assert geo["targ_dec"] == pytest.approx(-5.4170556)
    assert geo["pa_v3"] == pytest.approx(68.57554349924975)

    work = str(tmp_path / "rehearse_hdr")
    assert cli_main([
        "rehearse", "-w", work, "--header", fixture, "--pointings", "2",
        "-np", "61", "--step", "0.17", "--lambda-subsample", "12",
        "-hp", "1.0", "-ni", "25",
    ]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["band"] == "1a"
    assert rep["pa_v3"] == pytest.approx(geo["pa_v3"])
    assert rep["targ_ra"] == pytest.approx(geo["targ_ra"])
    assert rep["targ_dec"] == pytest.approx(geo["targ_dec"])
    # the rotated-FOV chain completed and reconstructs the data
    assert rep["residual_rel"] < 0.15, rep
    assert 0.8 < rep["flux_ratio_median"] < 1.2, rep
