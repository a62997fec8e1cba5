"""Channel parity at the REFERENCE's own fixture scale.

Builds band 2a with its real 970-sample detector wavelength table on a
251² sky grid (the `/root/reference/test/global_variable_testing.py:5-243`
fixture scale) for both our `Channel` and the reference
`spectroModelChannel.Channel` (via tests/reference_harness), feeds both the
same float64 inputs, and reports max relative deviation:

* forward:        ours.forward        vs ref.forward
* adjoint_latent: ours.adjoint_interp vs ref.adjoint (the reference's
  adjoint is its reverse-interpolation variant, not the exact transpose —
  its exact-transpose check is our dot-test suite)

Measured (2026-08, float64 CPU): forward 2.2e-15, adjoint 2.3e-15 — machine
precision.  Reference wall times at this scale: fwd 1326 s, adj 23 s
(serial NumPy/scipy); ours: fwd 3.9 s, adjoint_interp 41 s (single-thread
XLA CPU) — which is why the suite's default parity tests run at 41² and
this scale is script/env-gated (SURFH_SLOW_PARITY=1 enables the test).

Reference arrays are cached under .surfh_cache/parity/ for re-runs.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import numpy as np

from surfh_tpu.utils.cache import cache_dir


def build_pair(npix=251, band_name="2a", n_pointings=2, subsample=3,
               step_arcsec=0.025):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import reference_harness as rh
    from surfh_tpu.instrument import miri, wavelength_mrs
    from surfh_tpu.instrument.geometry import CoordList, get_srf
    from surfh_tpu.models.channel import Channel

    ref_instru = rh.load_reference_instru()
    ref_mod = rh.load_reference_channel(ref_instru)

    step = step_arcsec / 3600.0
    alpha = (np.arange(npix) - npix / 2) * step
    beta = (np.arange(npix) - npix / 2) * step
    band = miri.fusion_bands([band_name])[0]
    wl = wavelength_mrs.get_mrs_wavelength(band_name)
    ours_ifu = dataclasses.replace(band, wavel_axis=wl, pce=None)
    wavel_global = np.sort(wl)[::subsample].copy()

    srf = get_srf([ours_ifu.det_pix_size], step * 3600)[0]
    pts = CoordList.from_array(np.asarray(miri.dithering)[:n_pointings] / 3600.0)

    p = ours_ifu.pix(step)
    ref_ifu = ref_instru.IFU(
        fov=ref_instru.FOV(
            p.fov.alpha_width, p.fov.beta_width,
            origin=ref_instru.Coord(0, 0), angle=p.fov.angle,
        ),
        det_pix_size=p.det_pix_size, n_slit=p.n_slit,
        w_blur=ref_instru.SpectralBlur(p.w_blur.grating_resolution),
        pce=None, wavel_axis=np.asarray(p.wavel_axis), name=band_name.upper(),
    )
    ref_pts = ref_instru.CoordList(
        [ref_instru.Coord(q.alpha, q.beta) for q in pts]
    ).pix(step)

    ref_chan = ref_mod.Channel(ref_ifu, alpha, beta, wavel_global, srf, ref_pts, step)
    ours = Channel(ours_ifu, alpha, beta, wavel_global, srf, pts, step,
                   dtype=jnp.float64)
    assert tuple(ref_chan.oshape) == tuple(ours.oshape)
    return ref_chan, ours


def main():
    ref_chan, ours = build_pair()
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(ours.ishape)

    if os.path.exists(os.path.join(cache_dir("parity"), "yref.npy")):
        y_ref = np.load(os.path.join(cache_dir("parity"), "yref.npy"))
    else:
        t0 = time.time()
        y_ref = np.asarray(ref_chan.forward(cube))
        print(f"ref fwd {time.time()-t0:.1f}s", flush=True)
        os.makedirs(cache_dir("parity"), exist_ok=True)
        np.save(os.path.join(cache_dir("parity"), "yref.npy"), y_ref)
    t0 = time.time()
    y_ours = np.asarray(ours.forward(cube)).reshape(y_ref.shape)
    print(f"our fwd {time.time()-t0:.1f}s", flush=True)
    print("fwd max rel:", np.abs(y_ours - y_ref).max() / np.abs(y_ref).max(),
          flush=True)

    yr = rng.standard_normal(tuple(ref_chan.oshape))
    if os.path.exists(os.path.join(cache_dir("parity"), "aref.npy")):
        a_ref = np.load(os.path.join(cache_dir("parity"), "aref.npy"))
    else:
        t0 = time.time()
        a_ref = np.asarray(ref_chan.adjoint(yr))
        print(f"ref adj {time.time()-t0:.1f}s", flush=True)
        os.makedirs(cache_dir("parity"), exist_ok=True)
        np.save(os.path.join(cache_dir("parity"), "aref.npy"), a_ref)
    t0 = time.time()
    a_ours = np.asarray(ours.adjoint_interp(yr))
    print(f"our adjoint_interp {time.time()-t0:.1f}s", flush=True)
    print("adj max rel:", np.abs(a_ours - a_ref).max() / np.abs(a_ref).max(),
          flush=True)


if __name__ == "__main__":
    main()
