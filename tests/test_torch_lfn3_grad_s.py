"""S+PseudoReg LiteFlowNet3's supervised train step in the port against the
JAX package's, at the golden's params: `check_gradients` of
tests/test_torch_lfn3_grad.py (`lfn3_train_step`: `multiscale_sequence_loss`
through every S-only module), its loss, metrics, `grad_norm` and each
layer's gradient."""

from test_torch_lfn3_grad import check_gradients
from torch_threads import one_torch_thread  # noqa: F401


def test_gradients_match_jax_s_pseudoreg():
    check_gradients("s_pseudoreg", dict(use_s_version=True, use_pseudo_regularization=True))
