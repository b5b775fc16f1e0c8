"""The figure experiments on the port: the counterparts of
``figures/common.py`` and of the ``generate_data.py`` of the comparison and
teaser figures, run as ``python -m largesteps_torch.figures.comparison`` and
``python -m largesteps_torch.figures.teaser``.  Their CSV and PLY files have
the JAX experiments' names and columns, so ``figures/*/figure.py`` draws
them (``LS_OUTPUT_DIR`` names the directory)."""
