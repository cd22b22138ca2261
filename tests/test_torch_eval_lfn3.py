"""`eval/evaluate.py::make_lfn3_forward` against the JAX package's: LiteFlowNet3
at the goldens' params through both packages' `validate_sintel` on the
same on-disk tree (real frames), and each pair's flow and flow_low."""

import os

import jax
import jax.numpy as jnp
import numpy as np
from torch_threads import one_torch_thread  # noqa: F401

import torch_data_trees as trees
from raft_optical_flow_tpu.eval import evaluate as JE
from raft_optical_flow_tpu.models.liteflownet3 import LFN3Config as JaxLFN3Config
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint
from raft_optical_flow_tpu_torch.data import datasets as ds
from raft_optical_flow_tpu_torch.eval import evaluate as E
from raft_optical_flow_tpu_torch.models import LFN3Config
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from test_data_layer import _make_mini_sintel

PARAMS = os.path.join(os.path.dirname(__file__), "goldens", "lfn3_standard_params.npz")


def test_validate_sintel_with_lfn3_equals_jax(tmp_path):
    root = str(tmp_path / "sintel")
    _make_mini_sintel(root, scenes=("ambush_2",), frames=3, hw=(64, 96))
    trees.put_real_frames(root, "ambush_2")
    data = ds.MpiSintelVal(None, root=root, dstype="clean")
    samples = [data.__getitem__(i) for i in range(len(data))]
    fwd = E.make_lfn3_forward(LFN3Config(), load_flax_npz(PARAMS), device="cpu")
    jfwd = JE.make_lfn3_forward(JaxLFN3Config(),
                                jax.tree.map(jnp.asarray, load_flax_checkpoint(PARAMS)))
    for a, b, *_ in samples:
        flow, low = E._run_padded(fwd, a, b, mode="sintel")
        jflow, jlow = JE._run_padded(jfwd, a, b, mode="sintel")
        assert flow.shape == jflow.shape == (64, 96, 2) and low.shape == jlow.shape == (16, 24, 2)
        assert np.abs(flow - jflow).max() <= 1e-4 and np.abs(low - jlow).max() <= 1e-4
    res = E.validate_sintel(fwd, samples, "clean")
    ref = JE.validate_sintel(jfwd, samples, "clean")
    assert abs(res["clean"] - ref["clean"]) <= 1e-5
    one_pixel = 1.0 / (len(samples) * 64 * 96)
    for k in ("clean_1px", "clean_3px", "clean_5px"):
        assert abs(res[k] - ref[k]) <= one_pixel + 1e-12, k
