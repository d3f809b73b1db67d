"""The PyTorch port stands alone: it imports neither JAX nor any module of
the JAX package, and its entry points refuse to fall back to the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tvqaplus_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "tvqaplus_tpu")

torch.set_num_threads(1)


def port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    # the port's scripts that run on the card
    yield os.path.join(REPO, "scripts", "profile_torch_pipeline.py")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tvqaplus_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert len(names) > 15, names\n"
        "assert 'tvqaplus_tpu_torch.parallel.mesh' in names, names\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (path, node.lineno, roots)


def test_h5py_is_imported_only_where_artifacts_are_read():
    """h5py (absent on some machines) is imported inside the functions that
    read or write the TVQA+ HDF5 artifacts, never at a module's top."""
    where = []
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = set(map(id, tree.body))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == "h5py" for a in node.names):
                assert id(node) not in top, (path, node.lineno)
                where.append(os.path.relpath(path, REPO))
    assert sorted(where) == ["tvqaplus_tpu_torch/data/fixtures.py",
                             "tvqaplus_tpu_torch/data/tvqa.py"]
    code = ("import importlib, pkgutil, sys\n"
            "import tvqaplus_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'h5py' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from tvqaplus_tpu_torch import resolve_device
    from tvqaplus_tpu_torch.config import Config
    from tvqaplus_tpu_torch.infer.predict import InferenceRunner
    from tvqaplus_tpu_torch.inference import main_inference
    from tvqaplus_tpu_torch.models.stage import STAGE, ModelConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        main_inference(["--model_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceRunner(Config(), STAGE(ModelConfig(hsz=16, bridge_hsz=12,
                                                    embedding_size=32,
                                                    vfeat_size=16)))
    assert resolve_device("cpu") == torch.device("cpu")
