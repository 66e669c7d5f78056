"""Framework version, mirroring the reference's version package.

Reference: pkg/gofr/version/version.go:1-3

The port's copy of ``gofr_tpu/version.py``.
"""

FRAMEWORK = "0.1.0-dev"
