"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Nothing here compiles or loads at import: the library is built by nvcc on the
first launch (`_build.py`). The package's two entry points are the JAX
package's kernel entry points under the port's names:

  - `corr_pyramid_lookup_cuda` (`corr_pyramid_lookup_pallas`): the windowed
    lookup over a materialized correlation pyramid (K1, K2; K3 backward);
  - `ondemand_corr_pyramid_cuda` (`ondemand_corr_pyramid`): the on-demand
    correlation from the feature maps (K4; K5, K6 backward).
"""

from raft_optical_flow_tpu_torch.kernels.corr_lookup import corr_pyramid_lookup_cuda
from raft_optical_flow_tpu_torch.kernels.corr_ondemand import ondemand_corr_pyramid_cuda

__all__ = ["corr_pyramid_lookup_cuda", "ondemand_corr_pyramid_cuda"]
