"""Stage-by-stage parity diagnosis: our Channel vs the reference Channel.

Localizes where the forward outputs diverge: gridding,
SRF convolution, slit windows + weights, spectral blur.  Run on CPU:

    python scripts/diag_parity.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    scale = np.abs(b).max() or 1.0
    return np.abs(a - b).max() / scale


def main():
    import reference_harness as rh
    from test_channel_parity import _build_both

    ref_chan, ours, fx = _build_both()
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(ours.ishape)
    cube_w = cube[ours.wslice]

    import jax.numpy as jnp

    from surfh_tpu.core import bilinear, fft, wblur

    print(f"wslice ref={ref_chan.wslice} ours={ours.wslice}")
    print(f"wpsf rel diff: {rel(ours.wpsf, ref_chan.wpsf):.3e}")
    print(f"otf_sr rel: {rel(ours._otf_sr, ref_chan._otf_sr):.3e}")
    print(f"decalf rel: {rel(ours.decalf, ref_chan.decalf):.3e}")
    print(f"box_offset: {ours._box_offset}")

    for p_idx, pointing in enumerate(ref_chan.pointings):
        g_ref = ref_chan.gridding(cube_w, pointing)
        idx, w = ours._plans_fwd_dev[p_idx]
        g_ours = np.asarray(
            bilinear.apply_plan(idx, w, jnp.asarray(cube_w))
        ).reshape(g_ref.shape)
        print(f"p{p_idx} gridded rel: {rel(g_ours, g_ref):.3e}")

        # SRF conv stage (reference formula, both inputs)
        import surfh_tpu.core.fft as F

        def srf_conv(g):
            return np.fft.irfftn(
                np.fft.rfftn(g, axes=(-2, -1), norm="ortho")
                * (ref_chan._otf_sr * ref_chan.decalf),
                s=g.shape[-2:],
                axes=(-2, -1),
                norm="ortho",
            )

        s_ref = srf_conv(g_ref)
        s_ours_in = srf_conv(g_ours)
        print(f"p{p_idx} srf-conv rel (same stage, our gridded): {rel(s_ours_in, s_ref):.3e}")

        n_aout = ours.oshape[3]
        srf = ours.srf
        for slit_idx in range(min(2, ours.instr.n_slit)):
            # weights: reference weights full-res, ours subsampled-after-sum
            w_ref = ref_chan.slicer.get_slit_weights(
                slit_idx, ref_chan.slicer.get_slit_slices(slit_idx)
            )
            print(
                f"   ref slit{slit_idx} weights α-variation: "
                f"{np.abs(np.asarray(w_ref)[0] - np.asarray(w_ref)[0][0:1]).max():.3e}  "
                f"shape={np.asarray(w_ref).shape}"
            )

        # full forward per pointing
        y_ref = np.zeros(ours.oshape[1:])
        from surfh_tpu.instrument import miri  # noqa

        for slit_idx in range(ours.instr.n_slit):
            sliced = ref_chan.slicer.slicing(s_ref, slit_idx)
            import importlib

            ju = sys.modules["surfh.ToolsDir.jax_utils"]
            y_ref[slit_idx] = np.asarray(
                ju.wblur_subSampling(sliced, ref_chan.wpsf)
            )[:, : ours.oshape[3] * srf : srf]
        y_ours_full = np.asarray(ours.forward(cube)).reshape(ours.oshape)
        print(f"p{p_idx} forward-block rel: {rel(y_ours_full[p_idx], y_ref):.3e}")
        if p_idx == 0:
            d = np.abs(y_ours_full[0] - y_ref)
            sc = np.abs(y_ref).max()
            k = np.unravel_index(np.argmax(d), d.shape)
            print(f"   worst at (slit, λ', α)={k}, |d|/max={d[k]/sc:.3e}")
            per_alpha = d.max(axis=(0, 1)) / sc
            print(f"   per-α max rel: {np.array2string(per_alpha, precision=1, max_line_width=200)}")


if __name__ == "__main__":
    main()
