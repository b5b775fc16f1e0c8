"""The port's host C++ code: the BVH Hausdorff distance (copied from
``largesteps_tpu/native``), built by :mod:`largesteps_torch.native.build`."""
