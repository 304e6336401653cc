"""Plain PyTorch / NumPy references that decide a run's ``correct``.

Nothing here imports the program under test (``sdf_nmpc_tpu_torch``) or the
JAX package: each reference works its answer out again from the inputs the
harness made and the raw weight files both sides read.
"""
