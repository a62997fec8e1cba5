"""surfh_tpu — super-resolution and fusion for hyperspectral images in JAX.

A ground-up JAX/XLA re-design of the capabilities of `sidiso/surfh`
(JWST MIRI MRS super-resolved reconstruction and multi-band fusion):

* a physical linear instrument model ``y = Σ R L S C T x`` with exact adjoints,
* regularized least-squares solvers (conjugate gradient, MM memory gradient,
  closed-form Fourier inversion) running fully on device,
* multi-chip scaling through `jax.sharding` over the spectral axis,
* on-device template learning (NMF / PCA).

Layer map (bottom-up):

``core``          numeric kernels: unitary FFT, LMM, spectral blur, bilinear
                  gridding gather/scatter, Shepard interpolation, LinOp/dottest.
``instrument``    geometry & instrument spec: Coord/FOV/IFU/SpectralBlur and
                  the MIRI MRS band tables.
``models``        linear operators: Slicer, Channel, spectroSigRLSCT and the
                  full single-stage operator family, 2-D variants, mixing.
``solvers``       criteria and solvers.
``parallel``      device-mesh sharding of the forward/adjoint pipeline.
``preprocessing`` real-data distortion correction and filtering.
``simulation``    simulated ground-truth generation.
``learning``      NMF/PCA spectral template learning.
"""

__version__ = "0.1.0"
