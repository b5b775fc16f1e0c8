"""The figure experiments on the port: the counterparts of
``figures/common.py`` and of the ``generate_data.py`` of the comparison,
teaser, remeshing, multiscale, viewpoints, influence and reg_fail
figures, run as ``python -m largesteps_torch.figures.<name>``.  Their CSV and PLY files have the JAX
experiments' names and columns, so ``figures/*/figure.py`` draws them
(``LS_OUTPUT_DIR`` names the directory)."""
