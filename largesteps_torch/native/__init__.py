"""The port's host C++ code, copied from ``largesteps_tpu/native``: the BVH
Hausdorff distance, the Botsch-Kobbelt remesher (:mod:`.remesh`) and the
simplicial sparse Cholesky (:mod:`.cholesky`), built by
:mod:`largesteps_torch.native.build`."""
