"""Header-metadata utilities of the real-data correction chain.

Covers surfh_tpu/preprocessing/metadata.py against the semantics of the
reference one-off scripts (correct_RA_DEC_corrected_slices.py,
correct_rotation_slices.py, swipe_filter_corrected_mrs_data.py,
compare_fits_target_regarding_position.py, find_target_from_cal_file.py)
and the flux-comparison metrics of
compare_mean_flux_fusion_vs_real_data.py — all on synthetic files built
with our own fits_io.
"""

import os

import numpy as np
import pytest

from surfh_tpu.preprocessing import (
    fits_open,
    fits_write,
    mean_slit_world_coords,
    parse_raw_name,
    propagate_rotation,
    propagate_target_coords,
    rank_files_by_target_distance,
    swap_slit_blocks,
    swap_slit_blocks_in_files,
)
from surfh_tpu.preprocessing.fits_io import BLOCK, CARD, _format_card, _pad_block
from surfh_tpu.utils.metrics import (
    nonzero_mean_per_slice,
    points_in_polygon,
    region_mean_spectrum,
)


def _write_raw(path, pointing_cards):
    """Two-HDU raw-exposure stand-in: empty primary + float32 SCI HDU whose
    header carries the pointing keywords (like a stage-0/2 product, where
    RA_V1/DEC_V1/PA_V3 live in HDU 1)."""
    data = np.zeros((4, 4), dtype=np.float32)

    def header(cards):
        out = [_format_card(k, v) for k, v in cards]
        out.append(b"END".ljust(CARD))
        return _pad_block(b"".join(out))

    buf = header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0)])
    buf += header(
        [
            ("XTENSION", "IMAGE"),
            ("BITPIX", -32),
            ("NAXIS", 2),
            ("NAXIS1", 4),
            ("NAXIS2", 4),
            ("EXTNAME", "SCI"),
        ]
        + list(pointing_cards)
    )
    buf += _pad_block(data.astype(">f4").tobytes(), b"\x00")
    path.write_bytes(buf)


def test_parse_raw_name():
    assert parse_raw_name("ch1b_ch2b_0210j_00001_mirifushort_cal.fits") == (
        "ch1b",
        "ch2b",
        "0210j",
        "00001",
    )
    with pytest.raises(ValueError):
        parse_raw_name("too_few.fits")


def test_propagate_target_coords(tmp_path):
    raw = tmp_path / "raw"
    corr = tmp_path / "corr"
    filt = tmp_path / "filt"
    for d in (raw, corr, filt):
        d.mkdir()
    _write_raw(
        raw / "ch1a_ch2a_0210j_00001_mirifushort_cal.fits",
        [("RA_V1", 83.83), ("DEC_V1", -5.42)],
    )
    fits_write(str(corr / "ch1a_00001_corr.fits"), np.ones((3, 3)), header={"BAND": "SHORT"})
    fits_write(str(corr / "ch2a_00001_corr.fits"), np.ones((3, 3)))
    fits_write(str(corr / "ch1a_00002_corr.fits"), np.ones((3, 3)))  # other dither
    fits_write(str(filt / "ch2a_00001_filt.fits"), np.ones((3, 3)))

    n = propagate_target_coords(str(raw), [str(corr), str(filt)])
    assert n == 3

    hdr = fits_open(str(corr / "ch1a_00001_corr.fits"))[0].header
    assert hdr["TARG_RA"] == pytest.approx(83.83)
    assert hdr["TARG_DEC"] == pytest.approx(-5.42)
    assert hdr["BAND"] == "SHORT"  # carried keys survive the rewrite
    hdr = fits_open(str(filt / "ch2a_00001_filt.fits"))[0].header
    assert hdr["TARG_RA"] == pytest.approx(83.83)
    # mismatched dither untouched
    hdr = fits_open(str(corr / "ch1a_00002_corr.fits"))[0].header
    assert "TARG_RA" not in hdr


def test_propagate_rotation(tmp_path):
    raw = tmp_path / "raw"
    filt = tmp_path / "filt"
    raw.mkdir()
    filt.mkdir()
    _write_raw(raw / "ch3a_ch4a_0210j_00001_mirifulong_cal.fits", [("PA_V3", 100.0)])
    fits_write(str(filt / "ch3b_00001_filt.fits"), np.ones((3, 3)), header={"PA_V3": 0.0})
    fits_write(str(filt / "ch4a_00002_filt.fits"), np.ones((3, 3)))
    fits_write(str(filt / "ch1a_00001_filt.fits"), np.ones((3, 3)))

    n = propagate_rotation(str(raw), str(filt))
    assert n == 2
    assert fits_open(str(filt / "ch3b_00001_filt.fits"))[0].header["PA_V3"] == pytest.approx(107.5)
    assert fits_open(str(filt / "ch4a_00002_filt.fits"))[0].header["PA_V3"] == pytest.approx(108.3)
    assert "PA_V3" not in fits_open(str(filt / "ch1a_00001_filt.fits"))[0].header


def test_swap_slit_blocks_pure():
    n_slit, w = 3, 4
    data = np.arange(2 * n_slit * w, dtype=float).reshape(2, n_slit * w)
    swapped = swap_slit_blocks(data, n_slit=n_slit, block_width=w)
    # block i lands at slot n_slit-1-i
    np.testing.assert_array_equal(swapped[:, :w], data[:, 2 * w : 3 * w])
    np.testing.assert_array_equal(
        swap_slit_blocks(swapped, n_slit=n_slit, block_width=w), data
    )
    with pytest.raises(ValueError):
        swap_slit_blocks(np.zeros((2, 5)), n_slit=3, block_width=4)


def test_swap_slit_blocks_in_files(tmp_path):
    data = np.arange(2 * 17 * 24, dtype=np.float32).reshape(2, 17 * 24)
    fits_write(
        str(tmp_path / "ch2a_00001_filt.fits"),
        data,
        header={"PA_V3": 10.0, "TARG_RA": 1.0, "TARG_DEC": 2.0, "BAND": "MEDIUM"},
    )
    fits_write(str(tmp_path / "ch1a_00001_filt.fits"), data)  # not matched

    n = swap_slit_blocks_in_files(str(tmp_path), match="ch2")
    assert n == 1
    hdus = fits_open(str(tmp_path / "ch2a_00001_filt.fits"))
    np.testing.assert_array_equal(hdus[0].data, swap_slit_blocks(data))
    assert hdus[0].header["PA_V3"] == pytest.approx(10.0)
    assert hdus[0].header["BAND"] == "MEDIUM"
    np.testing.assert_array_equal(
        fits_open(str(tmp_path / "ch1a_00001_filt.fits"))[0].data, data
    )


def test_rank_files_by_target_distance(tmp_path):
    coords = {"far.fits": (10.0, 10.0), "near.fits": (1.1, 2.1), "mid.fits": (3.0, 4.0)}
    for name, (ra, dec) in coords.items():
        _write_raw(tmp_path / name, [("RA_V1", ra), ("DEC_V1", dec)])
    ranked = rank_files_by_target_distance(
        [str(tmp_path / n) for n in sorted(coords)], ref_ra=1.0, ref_dec=2.0
    )
    assert [os.path.basename(p) for p, _ in ranked] == ["near.fits", "mid.fits", "far.fits"]
    assert ranked[0][1] == pytest.approx(np.sqrt(0.02))


def test_mean_slit_world_coords():
    """Two slit stripes; the λ-range guard must drop the out-of-range one
    (find_target_from_cal_file.py:115-137 semantics)."""
    data = np.zeros((10, 8))

    def det2world(xs, ys):
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        # two stripes (xs 0-2 and 4-6) separated by NaN gap columns 3 and 7
        alpha = np.where(xs % 4 == 3, np.nan, xs * 0.1)
        beta = ys * 0.01
        lam = np.where(xs < 4, 5.0, 50.0)  # slit 2 far above the band
        return alpha, beta, lam

    wavel_axis = np.linspace(4.9, 5.7, 11)
    a, b = mean_slit_world_coords(
        "unused", wavel_axis, mode=0, wcs_loader=lambda p: (data, det2world)
    )
    # only the xs<4 stripe survives: mean alpha = 0.1*mean(0..2), beta = 0.01*mean(0..9)
    assert a == pytest.approx(0.1 * 1.0)
    assert b == pytest.approx(0.01 * 4.5)

    with pytest.raises(ValueError):
        mean_slit_world_coords(
            "unused",
            np.array([1.0, 1.1]),  # every slit out of range
            mode=0,
            wcs_loader=lambda p: (data, det2world),
        )
    with pytest.raises(ValueError):
        mean_slit_world_coords("unused", wavel_axis, mode=0, wcs_loader=None)


def test_nonzero_mean_per_slice():
    cube = np.zeros((3, 2, 2))
    cube[0] = [[1.0, 0.0], [3.0, 0.0]]
    cube[2] = [[2.0, 2.0], [2.0, 2.0]]
    out = nonzero_mean_per_slice(cube)
    np.testing.assert_allclose(out, [2.0, 0.0, 2.0])


def test_points_in_polygon_square():
    poly = [(0, 0), (0, 4), (4, 4), (4, 0)]
    pts = [(2, 2), (5, 2), (-1, 0), (3.9, 3.9)]
    np.testing.assert_array_equal(
        points_in_polygon(pts, poly), [True, False, False, True]
    )


def test_region_mean_spectrum_matches_manual():
    rng = np.random.default_rng(3)
    cube = rng.random((5, 12, 12))
    poly = [(2, 2), (2, 8), (8, 8), (8, 2)]  # axis-aligned square
    got = region_mean_spectrum(cube, poly)
    rows, cols = np.mgrid[2:9, 2:9]
    inside = points_in_polygon(
        np.stack([rows.ravel(), cols.ravel()], 1), poly
    )
    manual = cube[:, rows.ravel()[inside], cols.ravel()[inside]].mean(axis=1)
    np.testing.assert_allclose(got, manual)
    with pytest.raises(ValueError):
        region_mean_spectrum(cube, [(0.1, 0.1), (0.1, 0.2), (0.2, 0.15)])


def test_cli_metadata_and_compare_flux(tmp_path, capsys):
    """CLI plumbing for the metadata fix-ups and the flux comparison."""
    import json

    from surfh_tpu.cli import main as cli_main

    raw = tmp_path / "raw"
    filt = tmp_path / "filt"
    raw.mkdir()
    filt.mkdir()
    _write_raw(
        raw / "ch3a_ch4a_0210j_00001_mirifulong_cal.fits",
        [("PA_V3", 90.0), ("RA_V1", 1.0), ("DEC_V1", 2.0)],
    )
    fits_write(str(filt / "ch3a_00001_filt.fits"), np.ones((3, 3)))

    assert cli_main(
        ["metadata", "rotation", "--raw-dir", str(raw), "--slice-dir", str(filt)]
    ) == 0
    assert json.loads(capsys.readouterr().out)["files_updated"] == 1
    assert fits_open(str(filt / "ch3a_00001_filt.fits"))[0].header[
        "PA_V3"
    ] == pytest.approx(97.5)

    assert cli_main(
        ["metadata", "rank-target", "--raw-dir", str(raw), "--ref-ra", "1.0",
         "--ref-dec", "2.0"],
    ) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ranked"][0]["distance_deg"] == pytest.approx(0.0)

    rng = np.random.default_rng(0)
    fused = rng.random((6, 8, 8))
    real = rng.random((6, 8, 8))
    np.save(tmp_path / "fused.npy", fused)
    np.save(tmp_path / "real.npy", real)
    assert cli_main(
        ["compare-flux", "--fusion-cube", str(tmp_path / "fused.npy"),
         "--real-cube", str(tmp_path / "real.npy"), "--median-size", "0",
         "--region", "2,2;2,6;6,6;6,2",
         "--output", str(tmp_path / "flux.npz")],
    ) == 0
    assert json.loads(capsys.readouterr().out)["n_lambda"] == 6
    saved = np.load(tmp_path / "flux.npz")
    np.testing.assert_allclose(saved["mean_flux_fusion"], fused.mean(axis=(1, 2)))
    assert saved["region_spectrum"].shape == (6,)


def test_cli_make_cube_and_flux_plot(tmp_path, capsys):
    """make-cube mixes maps×templates exactly; plot_flux_comparison renders
    headless."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    from surfh_tpu.cli import main as cli_main
    from surfh_tpu.viz import plot_flux_comparison

    rng = np.random.default_rng(5)
    maps = rng.random((3, 7, 6))
    tpl = rng.random((3, 9))
    wavel = np.linspace(5.0, 6.0, 9)
    np.save(tmp_path / "maps.npy", maps)
    np.save(tmp_path / "tpl.npy", tpl)
    np.save(tmp_path / "wavel.npy", wavel)

    out_npy = tmp_path / "cube.npy"
    assert cli_main(
        ["make-cube", "--maps", str(tmp_path / "maps.npy"),
         "--templates", str(tmp_path / "tpl.npy"), "-o", str(out_npy)]
    ) == 0
    assert json.loads(capsys.readouterr().out)["cube_shape"] == [9, 7, 6]
    np.testing.assert_allclose(
        np.load(out_npy), np.einsum("mij,ml->lij", maps, tpl), rtol=1e-6
    )

    out_fits = tmp_path / "cube.fits"
    assert cli_main(
        ["make-cube", "--maps", str(tmp_path / "maps.npy"),
         "--templates", str(tmp_path / "tpl.npy"),
         "--wavel-axis", str(tmp_path / "wavel.npy"), "-o", str(out_fits)]
    ) == 0
    hdus = fits_open(str(out_fits))
    assert hdus[0].header["CRVAL3"] == pytest.approx(5.0)
    assert hdus[0].header["CDELT3"] == pytest.approx(0.125)
    assert hdus[0].data.shape == (9, 7, 6)

    fig = plot_flux_comparison(wavel, rng.random(9), rng.random(9), show=False)
    assert fig is not None


def test_region_mean_spectrum_outside_cube_raises():
    cube = np.ones((2, 5, 5))
    with pytest.raises(ValueError):
        region_mean_spectrum(cube, [(10, 10), (10, 12), (12, 12), (12, 10)])
