"""Measure the spectral-blur band density of the REAL instrument tables.

For each MIRI band, build the flagship channel's wpsf (the sinc² spectral
response sampled on the channel's λ-window — behavioural reference
/root/reference/surfh/Core/instru.py:499-572) and report, per truncation
threshold, the banded form's bandwidth LB vs the full window W, the FLOP
ratio vs the dense contraction, and the truncated mass (the error bound of
the banded product).

It answers whether the banded spelling (core/wblur_banded.py) is a default
win on the real tables rather than only on synthetic windows.

    python scripts/wpsf_density.py [--npix 121] [--bands 1a,...]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npix", type=int, default=121)
    ap.add_argument("--bands", type=str, default=None)
    ap.add_argument("--rtols", type=str, default="0,1e-6,1e-4,1e-3")
    ap.add_argument("--coarse", action="store_true",
                    help="Use the coarse PCE calibration λ grids instead of "
                         "the full detector tables.")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from surfh_tpu.core.wblur_banded import build_band_plan
    from surfh_tpu.instrument import miri
    from surfh_tpu.instrument.geometry import CoordList, get_srf
    from surfh_tpu.models.channel import Channel
    from surfh_tpu.simulation.flagship import (
        FLAGSHIP_STEP_ARCSEC,
        flagship_instruments,
        flagship_wavel_axis,
    )

    bands = args.bands.split(",") if args.bands else list(miri.BANDS)
    rtols = [float(r) for r in args.rtols.split(",")]

    # Same construction as SpectroSigRLSCT, without the sotf build.
    if args.coarse:
        instrs = miri.fusion_bands(bands)
        wavel = np.sort(
            np.concatenate([np.asarray(i.wavel_axis) for i in instrs])
        )
    else:
        instrs = flagship_instruments(bands)
        wavel = flagship_wavel_axis(bands)
    step_degree = FLAGSHIP_STEP_ARCSEC / 3600.0
    npix = args.npix
    alpha = (np.arange(npix) - npix / 2) * step_degree
    beta = (np.arange(npix) - npix / 2) * step_degree
    instrs = [i.pix(step_degree) for i in instrs]
    srfs = get_srf([i.det_pix_size for i in instrs], FLAGSHIP_STEP_ARCSEC)
    pts = CoordList.from_array(np.asarray(miri.dithering)[:1] / 3600.0)

    hdr = f"{'band':>5} {'K':>5} {'W':>5} {'B':>3} |"
    for r in rtols:
        hdr += f"  rtol={r:g}: LB dens mass |"
    print(hdr, flush=True)
    for b, instr, srf in zip(bands, instrs, srfs):
        chan = Channel(instr, alpha, beta, wavel, srf, pts, step_degree)
        wpsf = np.asarray(chan.wpsf)
        K, W, B = wpsf.shape
        line = f"{b:>5} {K:>5} {W:>5} {B:>3} |"
        total_mass = float(np.abs(wpsf).sum())
        for r in rtols:
            plan = build_band_plan(wpsf, rel_eps=r)
            LB = plan.LB
            kept = np.zeros_like(wpsf, bool)
            for t in range(plan.n_tiles):
                s0 = int(plan.starts[t])
                kept[t * plan.TK : (t + 1) * plan.TK, s0 : s0 + LB, :] = True
            lost = float(np.abs(wpsf[~kept]).sum()) / max(total_mass, 1e-300)
            line += f"  {LB:>4} {LB/W:5.2f} {lost:8.1e} |"
        print(line, flush=True)


if __name__ == "__main__":
    main()
