"""The example twins of examples/serve_lm.py and examples/analytics_geo.py
run their ``main()`` on the CPU at a reduced size and hold what the JAX
examples assert (the generated tokens' shape; the venue block tops the
whole-stream composite index); examples/torch_distributed_geo_join.py
needs the card unless asked for the CPU.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_twin():
    mod = _example("torch_serve_lm")
    out = mod.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16",
                    "--gen", "4"])
    assert out.shape == (2, 4)
    assert ((out >= 0) & (out < mod.CFG.vocab)).all()


def test_analytics_geo_twin():
    got = _example("torch_analytics_geo").main(["--device", "cpu",
                                                "--seconds", "8"])
    assert int(got["top"][0]) == got["venue"]
    assert got["counts"][got["venue"]] == np.max(got["counts"])
    region = got["snapshot"]["regions"][0]
    assert region["finalized_total"] > 0 and region["off_map"] == 0


def test_distributed_geo_join_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable,
                        "examples/torch_distributed_geo_join.py"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "accuracy" not in r.stdout
