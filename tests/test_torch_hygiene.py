"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no port example (``examples/torch_*.py``) imports
JAX or the JAX package ``repro`` (only the ``tests/test_torch_*`` files
import both), and the port never calls a library attention in place of
its kernels."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/kernels/ops.py" in names
    assert "chip_smoke.py" in names
    for module in ("serving/gateway/__init__", "serving/gateway/pool",
                   "serving/gateway/metrics", "serving/gateway/http",
                   "serving/gateway/client", "serving/simulator",
                   "launch/gateway", "training/__init__",
                   "training/optimizer", "training/train_step",
                   "training/checkpoint", "core/tree", "launch/train",
                   "launch/shapes", "launch/analysis", "launch/mesh",
                   "launch/dryrun", "distributed/sharding",
                   "kernels/launches", "kernels/xlstm"):
        assert f"src/repro_torch/{module}.py" in names
    assert len(names) > 20
    for example in ("quickstart", "offload_demo", "serve_chat",
                    "train_tiny"):
        assert f"examples/torch_{example}.py" in names
    # the import check below runs over every file found here, training/
    # and launch/train.py among them; the backward kernels' sources and
    # the xLSTM recurrences'
    for source in ("prefill_attention_bwd", "mamba_scan_bwd", "slstm_scan",
                   "slstm_scan_bwd", "mlstm_scan", "mlstm_scan_bwd"):
        assert (ROOT / "src" / "repro_torch" / "csrc"
                / f"{source}.cu").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_calls_no_library_attention():
    for path in PORT_FILES:
        if path.name == "chip_smoke.py":      # times SDPA as library_ms only
            continue
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path
    sources = sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))
    assert sources
    for path in sources:                # the kernels are written by hand
        text = path.read_text().lower()
        for name in ("cublas", "cudnn", "cutlass/gemm/device"):
            assert name not in text, f"{path.name} uses {name}"
