"""The fp32 reference against the port's CPU forward at a reduced size,
dense and MoE, on the same seeded weights; and it imports nothing of the
program or of JAX."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import small  # noqa: E402
from portbench.harness.weights import make_params, plain_weights  # noqa
from portbench.reference.model import logits_at  # noqa: E402


@pytest.mark.parametrize("registry", ["internlm2-20b", "deepseek-moe-16b"])
def test_reference_matches_the_port_forward(registry):
    from repro_torch.models import forward_train
    cfg, keys = small.reduced_config(registry, layers=2, d_model=64,
                                     vocab=128)
    params = make_params(cfg, seed=2**31 + 5, device="cpu")
    gen = torch.Generator().manual_seed(3)
    seqs = [torch.randint(0, 128, (n,), generator=gen).tolist()
            for n in (9, 23)]
    wanted = [list(range(len(s))) for s in seqs]
    ref = logits_at(keys, plain_weights(params), seqs, wanted)
    with torch.no_grad():
        for s, r in zip(seqs, ref):
            port, _ = forward_train(params, cfg,
                                    {"tokens": torch.tensor([s])})
            torch.testing.assert_close(r, port[0].float(), rtol=1e-4,
                                       atol=1e-4)


def test_int8_control_departs_from_fp32():
    cfg, keys = small.reduced_config("internlm2-20b")
    params = make_params(cfg, seed=9, device="cpu")
    seqs = [list(range(1, 30))]
    w = plain_weights(params)
    a = logits_at(keys, w, seqs, [list(range(29))])[0]
    b = logits_at(keys, w, seqs, [list(range(29))], precision="int8")[0]
    assert (a - b).abs().max() > 1e-3


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "jaxlib", "flax"), (path, n)
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = eval(out.strip().splitlines()[-1])
    for bad in ("repro_torch", "repro", "jax", "jaxlib", "flax"):
        assert bad not in loaded
