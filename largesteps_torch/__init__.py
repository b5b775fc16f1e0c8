"""largesteps_torch — the PyTorch/CUDA port of ``largesteps_tpu``.

Inverse rendering of geometry with the large-steps parameterization
``u = (I + λL) v``, a differentiable multi-view rasterizer whose four
per-tile kernels are hand-written CUDA for Hopper, and AdamUniform.  The JAX
package ``largesteps_tpu`` stays the reference; this package imports neither
it nor ``jax``.  Entry points run on the CUDA device unless a caller passes
``device="cpu"``, which routes every kernel to its plain PyTorch version.
"""
