"""The port's four examples (``examples/torch_*.py``, twins of the
reference's) run to their own assertions on the CPU with ``--device cpu``,
at the sizes their flags allow; without the flag they take the card."""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent

CASES = {
    # on the CPU the plain versions run: no kernel is launched
    "quickstart": ([], ["OK — device, host-offloaded and raw decode all "
                        "agree", '"decode_attention": 0, '
                        '"prefill_attention": 0']),
    "offload_demo": ([], ["<- token completes"]),
    "serve_chat": (["--requests", "3", "--perf-model", "analytic"],
                   ["per-iteration strategy decisions"]),
    "train_tiny": (["--steps", "1", "--batch", "1", "--seq", "8"],
                   ["checkpoint committed and restored at step 1"]),
}


def run_example(name, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(name):
    args, expect = CASES[name]
    proc = run_example(name, "--device", "cpu", *args)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    for text in expect:
        assert text in proc.stdout, text


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_examples_default_to_the_card():
    proc = run_example("quickstart", timeout=120)
    assert proc.returncode != 0
