"""Package rules of the PyTorch port, read from the sources with `ast`.

`raft_optical_flow_tpu_torch`, `chip_smoke.py` and
`tools/profile_port_raft.py` import neither JAX, flax,
optax, PIL, cv2, grain, tensorboardX, tensorboard, matplotlib, protobuf
(`google`) nor the JAX package (the card's machine has none of
them); the kernels
are built by nvcc and bound through ctypes, never through
`torch.utils.cpp_extension` or `torch.compile`; entry points default to the
card.
"""

import ast
import inspect
import os

import pytest

from raft_optical_flow_tpu_torch.cli import demo, evaluate, train_flow, train_raft
from raft_optical_flow_tpu_torch.data.pipeline import prefetch_to_device
from raft_optical_flow_tpu_torch.eval import make_lfn3_forward, make_raft_forward
from raft_optical_flow_tpu_torch.models import (
    RAFT,
    IFNet,
    LiteFlowNet3,
    SimpleFlowNet,
    ifnet,
    simple_flow_net,
)
from raft_optical_flow_tpu_torch.ops.grid import coords_grid
from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer, create_train_state
from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer
from raft_optical_flow_tpu_torch.utils import export, grad_parity, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "raft_optical_flow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "PIL", "cv2", "grain", "raft_optical_flow_tpu",
             "tensorboardX", "tensorboard", "matplotlib", "google")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tools", "profile_port_raft.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]  # build outputs
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return tree, names


def test_sources_found():
    srcs = _sources()
    assert len(srcs) >= 15
    for rel in (("kernels", "corr_lookup.py"), ("train", "trainer.py"), ("cli", "train_raft.py"),
                ("losses", "sequence.py"), ("utils", "checkpoint.py"), ("data", "pipeline.py"),
                ("data", "synthetic.py"), ("train", "configs.py"), ("models", "liteflownet3.py"),
                ("ops", "warp.py"), ("ops", "spatial_corr.py"), ("models", "simple_flow.py"),
                ("models", "ifnet.py"), ("losses", "laploss.py"), ("losses", "unsupervised.py"),
                ("losses", "simple_flow_loss.py"), ("ops", "unflow_ops.py"), ("losses", "uflow.py"),
                ("losses", "unflow.py"), ("train", "trainers.py"), ("cli", "train_flow.py"),
                ("data", "native.py"), ("data", "frame_utils.py"), ("data", "cv.py"),
                ("data", "augmentor.py"), ("data", "datasets.py"), ("utils", "flow_viz.py"),
                ("eval", "evaluate.py"), ("cli", "evaluate.py"), ("cli", "demo.py"),
                ("ops", "corr.py"), ("ops", "grid.py"), ("ops", "padding.py"),
                ("utils", "torch_convert.py"), ("utils", "export.py"),
                ("utils", "grad_parity.py"), ("utils", "profiling.py"), ("utils", "logging.py")):
        assert os.path.join(PORT, *rel) in srcs


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_pil_or_jax_package_import(path):
    _, names = _imports(path)
    for name in names:
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_cpp_extension_or_torch_compile(path):
    tree, names = _imports(path)
    assert not any("cpp_extension" in n for n in names), path
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("compile", "cpp_extension") or not (
                isinstance(node.value, ast.Name) and node.value.id == "torch"
            ), f"{path} uses torch.{node.attr}"


def test_kernel_source_is_cuda_for_sm90a():
    src = open(os.path.join(PORT, "kernels", "csrc", "corr_lookup.cu")).read()
    assert "torch/extension.h" not in src and "pybind11" not in src
    build = open(os.path.join(PORT, "kernels", "_build.py")).read()
    assert "arch=compute_90a,code=sm_90a" in build


def test_entry_points_default_to_cuda():
    assert inspect.signature(RAFT.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(LiteFlowNet3.__init__).parameters["device"].default == "cuda"
    for fn in (SimpleFlowNet.__init__, IFNet.__init__, simple_flow_net, ifnet):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert inspect.signature(coords_grid).parameters["device"].default == "cuda"


def test_training_entry_points_default_to_cuda():
    for fn in (RAFTTrainer.__init__, create_train_state, prefetch_to_device, FlowTrainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert train_raft.parse_args(["--stage", "chairs"]).device == "cuda"
    assert train_flow.parse_args(["--model", "ifnet"]).device == "cuda"


def test_inference_entry_points_default_to_cuda():
    for fn in (make_raft_forward, make_lfn3_forward):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert evaluate.parse_args(["--model", "m.npz"]).device == "cuda"
    assert demo.parse_args(["--model", "m.npz"]).device == "cuda"


def test_utils_entry_points_default_to_cuda():
    for fn in (export.export_raft, export.export_lfn3, grad_parity.run_all,
               profiling.compare_models):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
