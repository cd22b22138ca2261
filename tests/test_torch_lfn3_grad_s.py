"""S+PseudoReg LiteFlowNet3's loss and per-layer gradients in the port against
`jax.value_and_grad`, at the golden's params; the check and its gates are
those of tests/test_torch_lfn3_grad.py (S+PseudoReg has every S-only
module)."""

from test_torch_lfn3_grad import check_gradients
from torch_threads import one_torch_thread  # noqa: F401


def test_gradients_match_jax_s_pseudoreg():
    check_gradients("s_pseudoreg", dict(use_s_version=True, use_pseudo_regularization=True))
