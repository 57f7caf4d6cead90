"""Recommendation serving tier: training produces ``(W, H)``; this
package consumes them.

* :mod:`~repro_torch.serve.topk`   — batched top-k scoring (the plain
  tiled scan and the CUDA top-k kernel, exact vs. the dense argsort
  oracle).
* :mod:`~repro_torch.serve.store`  — :class:`FactorStore`:
  double-buffered, version-stamped factors on the device (readers always
  see one consistent version).
* :mod:`~repro_torch.serve.server` — :class:`RecServer`: microbatching
  request front end; boots from a ``save_fit_result`` checkpoint.
"""
from .server import Recommendation, RecServer, ServeConfig, ServeTimeout
from .store import FactorStore, FactorView, quantize_int8
from .topk import topk_dense_oracle, topk_scores, topk_scores_filtered

__all__ = [
    "FactorStore", "FactorView", "Recommendation", "RecServer",
    "ServeConfig", "ServeTimeout", "quantize_int8", "topk_dense_oracle",
    "topk_scores", "topk_scores_filtered",
]
