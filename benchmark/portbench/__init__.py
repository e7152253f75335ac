"""The harness of the port's benchmark: finding a cell's files
(``manifest``), one run (``harness``), the traced window (``trace``), the
cases (``synthetic``, ``nifti``), the seeded weights (``weights``), what is
counted on the plain network (``model``), and the chip's peaks and the
kernels' work (``roofline``, ``kernelshare``)."""
