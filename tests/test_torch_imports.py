"""The port stands alone: no file under src/repro_torch, and not
chip_smoke.py or the examples/torch_*.py twins, imports ``jax`` or the
JAX package ``repro`` (an AST scan of every import statement), importing
the port's engine, serving, front-end, artifact, enrichment, data,
analytics, obs, model-stack (the MoE layer and its dispatch, the SSM
and xLSTM blocks included), mesh, sharding-rule and sharded-lookup or
training modules (optimizer, checkpoint manager, driver, train launcher)
loads neither (one interpreter imports them in turn), chip_smoke.py
refuses to run without a CUDA device, and the serving launcher and the
quickstart twin run on the CPU only when asked (``--device cpu``).
"""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "src", "repro_torch", "**",
                                    "*.py"), recursive=True)
) + ["chip_smoke.py"] + sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "examples", "torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:                 # relative: stays in the package
                continue
            yield node.module.split(".")[0], node.lineno


def test_port_files_found():
    assert len(PORT_FILES) >= 77
    for path in ("core/engine.py", "serving/server.py",
                 "analytics/aggregate.py", "obs/profile.py",
                 "kernels/segment.py", "models/model.py",
                 "kernels/flash_attn.py", "launch/serve.py",
                 "runtime/steps.py", "configs/qwen1_5_0_5b.py",
                 "optim/adamw.py", "checkpoint/manager.py",
                 "runtime/driver.py", "launch/train.py", "models/moe.py",
                 "distributed/dispatch.py", "distributed/__init__.py",
                 "models/ssm.py", "models/xlstm.py", "launch/mesh.py",
                 "core/distributed.py", "sharding/rules.py",
                 "sharding/__init__.py"):
        assert f"src/repro_torch/{path}" in PORT_FILES
    for name in ("train_lm", "distributed_geo_join", "serve_lm",
                 "analytics_geo"):
        assert f"examples/torch_{name}.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_repro_import(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_engine_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = _run(["-c", "import sys, repro_torch.core.engine, "
              "repro_torch.kernels.ops; "
              "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')); print(bad); "
              "sys.exit(1 if bad else 0)"], cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout + r.stderr


SLICE_MODULES = ["repro_torch.serving", "repro_torch.serving.frontend",
                 "repro_torch.core.artifact", "repro_torch.core.enrich",
                 "repro_torch.data", "repro_torch.analytics",
                 "repro_torch.obs", "repro_torch.models.model",
                 "repro_torch.launch.serve", "repro_torch.runtime.steps",
                 "repro_torch.optim.adamw", "repro_torch.checkpoint.manager",
                 "repro_torch.runtime.driver", "repro_torch.launch.train",
                 "repro_torch.models.moe", "repro_torch.distributed.dispatch",
                 "repro_torch.models.ssm", "repro_torch.models.xlstm",
                 "repro_torch.launch.mesh", "repro_torch.core.distributed",
                 "repro_torch.sharding.rules"]
# One interpreter imports SLICE_MODULES in turn and prints, for each, the
# forbidden modules that are new in ``sys.modules`` after it (or the
# import's error).  A forbidden module stays loaded once in, so the
# module that pulls it in is the one that shows it.
_IMPORT_IN_TURN = """
import importlib, json, sys
def bad():
    return {m for m in sys.modules if m.split('.')[0] in %r}
seen, out = bad(), {}
for name in %r:
    try:
        importlib.import_module(name)
    except Exception as e:
        out[name] = ['error: %%r' %% (e,)]
        continue
    now = bad()
    out[name] = sorted(now - seen)
    seen = now
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def slice_imports():
    """{module: the forbidden modules its import added (or its error)},
    from one interpreter."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = _run(["-c", _IMPORT_IN_TURN % (FORBIDDEN, SLICE_MODULES)], cwd=REPO,
             env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_import_loads_no_jax(slice_imports, module):
    """The serving, analytics and obs packages, the model stack and the
    training modules load neither ``jax`` nor ``repro`` (the server pulls
    in the engine, the kernels and numpy copies of the reference's host
    modules; the model stack the configs, which are copies, and the
    kernels; the train launcher the data pipeline)."""
    assert slice_imports[module] == [], slice_imports[module]


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke exits non-zero and prints no result,
    from the repo and from a directory that holds only the script."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(tmp_path)):
        r = _run(["chip_smoke.py"], cwd=cwd)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_serve_launcher_needs_no_jax_and_no_fallback():
    """``python -m repro_torch.launch.serve`` runs the reduced qwen on the
    CPU when asked, and without a card fails at its default
    ``--device cuda`` rather than falling back."""
    import torch
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    args = ["-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
            "--reduced", "--batch", "1", "--prompt-len", "8", "--gen", "3"]
    r = _run(args + ["--device", "cpu"], cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[serve] qwen1.5-0.5b-reduced: prefill 1x8" in r.stdout
    if torch.cuda.is_available():
        return
    r = _run(args, cwd=REPO, env=env)
    assert r.returncode != 0 and "[serve]" not in r.stdout


def test_quickstart_twin_needs_the_card_unless_asked():
    """examples/torch_quickstart.py defaults to ``--device cuda`` and,
    without a card, fails rather than falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run")
    assert "examples/torch_quickstart.py" in PORT_FILES
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = _run(["examples/torch_quickstart.py", "--points", "100"], cwd=REPO,
             env=env)
    assert r.returncode != 0 and "accuracy" not in r.stdout
