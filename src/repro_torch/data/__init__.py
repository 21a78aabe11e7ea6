"""Data-side of the port: the synthetic LM pipeline (``data.pipeline``)
and the GSL-LPA uses of ``data.clustering``."""
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: F401
