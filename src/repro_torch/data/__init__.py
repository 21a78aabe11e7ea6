"""Data-side uses of GSL-LPA: the port's ``data.clustering``."""
