"""The flow's transforms, as modules (counterpart of
`flowcompare_tpu/flows/__init__.py`)."""

from . import actnorm, augment, coupling, distributions, permuters, spline

__all__ = ["actnorm", "augment", "coupling", "distributions", "permuters", "spline"]
