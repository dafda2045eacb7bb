"""The port stands alone: no module of ``acvae_tpu_torch`` and not
``chip_smoke.py`` imports jax, flax, optax or anything of ``acvae_tpu``; and
none imports PyYAML, pandas or nltk, which the card's machine lacks (h5py
only inside the HDF5 feature reader, at its first use)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "acvae_tpu")
SOURCES = sorted((ROOT / "acvae_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


HOST_ONLY = ("yaml", "pandas", "nltk", "h5py")
# the one place h5py may be imported: inside the HDF5 reader, lazily
LAZY_H5PY = ("acvae_tpu_torch/data/dataset.py", "_open_store")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_host_only_packages(path):
    rel = str(path.relative_to(ROOT))
    tree = ast.parse(path.read_text(), rel)
    allowed = set()
    for fn in ast.walk(tree):
        if (isinstance(fn, ast.FunctionDef) and (rel, fn.name) == LAZY_H5PY):
            allowed |= {id(n) for n in ast.walk(fn)}
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for m in names:
            if m.split(".")[0] in HOST_ONLY:
                assert m == "h5py" and id(node) in allowed, f"{rel} imports {m}"


def test_port_imports_without_a_card():
    """Every port module imports on a machine with no nvcc and no card."""
    import importlib
    for p in SOURCES[:-1]:
        mod = ".".join(p.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))


def test_sweep_advisor_needs_only_numpy():
    """The sweep's advisors are host code: numpy and the standard library."""
    path = ROOT / "acvae_tpu_torch" / "train" / "sweep_advisor.py"
    assert path in SOURCES
    assert {m.split(".")[0] for m in _imports(path)} <= {
        "__future__", "math", "typing", "numpy"}


@pytest.mark.parametrize("argv", [
    ["sweep", "configs/ac_vae.yaml", "--param=beta", "--values=0.5"],
    ["import_torch", "best.pth", "configs/ac_vae.yaml", "out", "vocab.pkl"],
    ["doctor"]], ids=lambda a: a[0])
def test_new_commands_refuse_to_start_without_a_card(argv):
    """sweep, import_torch and doctor compute on the device: they default to
    the card and, with none, refuse before doing anything."""
    import torch

    from acvae_tpu_torch.cli import main as cli

    assert argv[0] in cli.ON_DEVICE and argv[0] in cli.COMMANDS
    assert {"report_results", "split_dataset", "concat_json", "concat_csv",
            "tsne"} <= set(cli.COMMANDS) - set(cli.ON_DEVICE)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA card.*--device=cpu"):
        cli.main(argv)


def test_parity_harness_stays_out_of_the_package():
    """``parallel/parity.py``, the step checks of the tests and
    ``chip_smoke.py``, is imported by no module of the package."""
    harness = "acvae_tpu_torch.parallel.parity"
    users = []
    for path in SOURCES[:-1]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            else:
                continue
            if any(n == harness or n.startswith(harness + ".") for n in names):
                users.append(str(path.relative_to(ROOT)))
    assert not users, f"{users} import the parity harness"
