"""chip_smoke.py's phases at tiny sizes on the CPU, and its GPU-only guard.

On the GPU the script runs the same phase functions at the full flagship
width; here they run on a 2-band, 2-pointing, 41² cut with the matmul conv
(the GPU policy's choice, with the λ-rank factorization and PSF stamps).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke


@pytest.fixture(scope="module")
def tiny_flagship():
    return chip_smoke.phase_build(npix=41, bands=["1a", "3b"], n_pointings=2,
                                  lambda_subsample=24, conv_impl="matmul")


def test_phase_build_and_apply(tiny_flagship, capsys):
    fl = tiny_flagship
    assert fl.model.conv_impl == "matmul" and fl.model.psf_stack is not None
    out = chip_smoke.phase_apply(fl, n_apps=2)
    assert len(out["app_s"]) == 2 and out["dot_rel"] <= chip_smoke.DOT_RTOL
    log = capsys.readouterr().out
    assert "dot test" in log and "peak_bytes_in_use" in log


def test_phase_solve(tiny_flagship):
    g = chip_smoke.phase_solve(tiny_flagship, n_iter=3)
    assert g.shape == (4,) and np.isfinite(g).all() and g[-1] < g[0]


def test_phase_parity_and_wblur(capsys):
    # a 41² grid is smaller than the band's field of view: border pixels
    # carry large signed gather weights, so f32 rounding shows up to ~1e-4
    model = chip_smoke.phase_parity(band="1c", npix=41, n_pointings=1,
                                    lambda_subsample=24, f32_rtol=1e-3)
    out = chip_smoke.phase_wblur(model.channels[0], reps=1)
    assert {"dense_ms", "banded_0_ms", "banded_0.0001_ms"} <= set(out)
    log = capsys.readouterr().out
    assert "parity forward" in log and "parity adjoint" in log


def test_phase_four_cards_on_virtual_devices():
    out = chip_smoke.phase_four_cards(
        n_dev=4, npix=41, bands=["1a", "1b", "2a", "3b"], n_pointings=2,
        lambda_subsample=24, n_iter=2, conv_impl="matmul")
    assert out["cg solution"] <= chip_smoke.SHARD_CG_RTOL
    assert out["table_bytes"]["per_device"] < out["table_bytes"]["replicated_would_be"]


def test_main_refuses_cpu(capsys):
    assert chip_smoke.device_info()["platform"] == "cpu"
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--four-cards"]) == 2
    assert '"ok"' not in capsys.readouterr().out  # no result line
