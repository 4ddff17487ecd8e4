"""Analytic cost accounting, and the proxy sample-quality metrics."""
from repro_torch.metrics.fid import (features, fid_proxy,
                                     inception_score_proxy)

__all__ = ["features", "fid_proxy", "inception_score_proxy"]
