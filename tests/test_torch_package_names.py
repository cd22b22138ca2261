"""Each name a JAX subpackage exports (its `__all__`) imports from the port's
subpackage of the same name; the two kernel entry points under the port's
names. The JAX package's `__all__` lists are read from its sources with
`ast` (no JAX import). Importing `raft_optical_flow_tpu_torch.kernels` builds
and loads no library: nvcc runs on the first launch.
"""

import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "raft_optical_flow_tpu")
PORT_NAMES = {  # the JAX package's kernel entry points -> the port's
    "corr_pyramid_lookup_pallas": "corr_pyramid_lookup_cuda",
    "ondemand_corr_pyramid": "ondemand_corr_pyramid_cuda",
}


def _jax_all(sub):
    tree = ast.parse(open(os.path.join(JAX_PKG, sub, "__init__.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


SUBPACKAGES = sorted(d for d in os.listdir(JAX_PKG)
                     if os.path.isfile(os.path.join(JAX_PKG, d, "__init__.py")))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    port = importlib.import_module(f"raft_optical_flow_tpu_torch.{sub}")
    names = [PORT_NAMES.get(n, n) for n in _jax_all(sub)]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"raft_optical_flow_tpu_torch.{sub} lacks {missing}"
    if names:  # and `from ... import *` gives them (the port may export more)
        assert set(names) <= set(port.__all__)


def test_train_and_kernels_names():
    from raft_optical_flow_tpu_torch.kernels import ondemand_corr_pyramid_cuda
    from raft_optical_flow_tpu_torch.kernels.corr_ondemand import ondemand_corr_pyramid_cuda as od
    from raft_optical_flow_tpu_torch.train import RAFTTrainer
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer as trainer

    assert ondemand_corr_pyramid_cuda is od and RAFTTrainer is trainer
    assert set(_jax_all("train")) == {"RAFTTrainer", "TrainState", "make_optimizer",
                                      "raft_train_step", "StageConfig", "STANDARD_CURRICULUM"}


def test_kernels_import_loads_no_library():
    code = (
        "import os\n"
        "import raft_optical_flow_tpu_torch.kernels as k\n"
        "from raft_optical_flow_tpu_torch.kernels import _build, corr_lookup, corr_ondemand, "
        "gru_fused\n"
        "assert k.corr_pyramid_lookup_cuda and k.ondemand_corr_pyramid_cuda\n"
        "assert all(m._lib is None for m in (_build, corr_lookup, corr_ondemand, gru_fused))\n"
        "maps = '/proc/self/maps'\n"
        "assert not os.path.exists(maps) or 'libraft_kernels' not in open(maps).read()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
