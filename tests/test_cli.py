"""CLI and checkpoint/resume behavior."""

import json
import os

import numpy as np
import pytest

from surfh_tpu.cli import main as cli_main
from surfh_tpu.solvers.checkpoint import load_checkpoint, run_checkpointed, save_checkpoint


def _run(capsys, argv):
    """Run one CLI command; returns its last stdout line parsed as JSON."""
    assert cli_main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_imports_without_click(monkeypatch):
    """The CLI is stdlib argparse: it imports with `click` unavailable."""
    import importlib
    import sys

    import surfh_tpu.cli as cli_mod

    monkeypatch.setitem(sys.modules, "click", None)  # import click -> error
    importlib.reload(cli_mod)
    assert cli_mod.build_parser().parse_args(["info"]).command == "info"


def test_cli_info(capsys):
    assert cli_main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "devices" in out


def test_cli_fusion_simulated(tmp_path, capsys):
    report = _run(capsys, [
        "fusion", "--simulated", "-np", "31", "--n-lambda", "16",
        "-nc", "1", "-nt", "3", "-ni", "8", "-hp", "10", "-o", str(tmp_path),
    ])
    assert report["niter"] > 0
    assert os.path.exists(tmp_path / "res_x.npy")
    assert os.path.exists(tmp_path / "res_cube.npy")


def test_cli_deconv2d(tmp_path, capsys):
    report = _run(capsys, ["deconv2d", "-np", "41", "-ni", "20", "-o", str(tmp_path)])
    assert report["niter"] > 0
    assert os.path.exists(tmp_path / "deconv2d_x.npy")


def test_cli_deconv_cube(tmp_path, capsys):
    """BASELINE config 2 as one command (deconvolution_mrs_noRotation.py)."""
    report = _run(capsys, [
        "deconv-cube", "-np", "41", "-nl", "4", "-ni", "15", "-o", str(tmp_path),
    ])
    assert report["niter"] > 0 and report["n_lambda"] == 4
    assert os.path.exists(tmp_path / "deconv_cube_x.npy")


def test_cli_gen_psf(tmp_path, capsys):
    """webbpsf_generation.py as one webbpsf-free command (utils/jwst_psf)."""
    import numpy as np

    wpath = tmp_path / "wavels.npy"
    np.save(wpath, np.array([8.0, 10.0]))
    out = tmp_path / "psf.npy"
    report = _run(capsys, [
        "gen-psf", "-w", str(wpath), "--npix", "65", "--n-pupil", "128",
        "-o", str(out),
    ])
    assert report["n_lambda"] == 2
    stack = np.load(out)
    assert stack.shape == (2, 65, 65) and stack.dtype == np.float32
    assert float(stack.sum(axis=(1, 2)).max()) <= 1.0 + 1e-3


def test_cli_allband(tmp_path, capsys):
    """BASELINE config 5 as one command: data → dirty co-add → on-device NMF
    → fusion with learned templates → metrics (2-band CPU-sized run)."""
    report = _run(capsys, [
        "allband", "-np", "31", "-b", "1a,1b", "--pointings", "2",
        "-nt", "2", "-ni", "8", "--nmf-iter", "40",
        "--lambda-subsample", "4", "-o", str(tmp_path),
    ])
    assert report["niter"] > 0 and report["bands"] == ["1a", "1b"]
    assert "nmf_s" in report["timings_s"] and "solve_s" in report["timings_s"]
    assert np.isfinite(report["psnr_cube"])
    assert os.path.exists(tmp_path / "allband_templates.npy")


def test_checkpoint_save_load(tmp_path):
    p = str(tmp_path / "state.npz")
    x = np.arange(12.0).reshape(3, 4)
    save_checkpoint(p, x, 7, [1.0, 0.5], [2.0])
    ck = load_checkpoint(p)
    assert ck["n_iter_done"] == 7
    np.testing.assert_array_equal(ck["x"], x)


def test_checkpointed_run_resumes(tmp_path):
    """A segmented checkpointed solve must match a straight solve."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    model, setup = make_model(
        im_size=31, n_lambda=16, n_tpl=3, n_channels=1, n_pointings=1,
        n_slit=3, dtype=jnp.float64,
    )
    y = np.asarray(model.forward(setup["maps"]))
    crit = QuadCriterion_MRS(1.0, y, model, 10.0)
    straight = crit.run_method("lcg", maximum_iterations=12)

    p = str(tmp_path / "cg.npz")
    seg = run_checkpointed(crit, "lcg", niter=12, checkpoint_path=p, checkpoint_every=4)
    # full CG state is carried across segments: identical to the straight run
    np.testing.assert_allclose(seg.x, straight.x, rtol=1e-10, atol=1e-12)
    assert seg.n_iter == 12

    # resuming a finished run must be a no-op returning the stored iterate
    again = run_checkpointed(crit, "lcg", niter=12, checkpoint_path=p, checkpoint_every=4)
    np.testing.assert_array_equal(again.x, seg.x)


def test_fusion_config_roundtrip(tmp_path):
    from surfh_tpu.config import FusionConfig, data_root

    cfg = FusionConfig(bands=["1a"], simulated=True)
    cfg.solver.niter = 7
    p = str(tmp_path / "cfg.json")
    cfg.to_json(p)
    back = FusionConfig.from_json(p)
    assert back.solver.niter == 7 and back.bands == ["1a"] and back.simulated
    import os
    os.environ["SURFH_DATA_ROOT"] = "/tmp/xyz"
    try:
        assert data_root() == "/tmp/xyz"
        assert data_root("/a") == "/a"
    finally:
        del os.environ["SURFH_DATA_ROOT"]


def test_fusion_config_rejects_unknown():
    import pytest as _pytest

    from surfh_tpu.config import FusionConfig

    with _pytest.raises(ValueError):
        FusionConfig.from_dict({"bogus": 1})
