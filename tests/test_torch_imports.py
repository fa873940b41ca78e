"""Import boundary and device rules of the PyTorch port (dsmnet_tpu_torch).

  * The port and chip_smoke.py import nothing of JAX, flax or the JAX
    package ``dsmnet_tpu``, and nothing of cv2, msgpack or matplotlib,
    which the card's machine may lack (the modules that read image files,
    JAX's msgpack files or plot import them when called): checked in a
    fresh interpreter.
  * Entry points default to CUDA and raise when it is absent: checked in a
    subprocess with every card hidden, so the check means the same on any
    host (the entry points' subprocesses run at once).
  * A kernel wrapper asked for its CUDA path on a CPU tensor raises before
    it computes anything.
  * Every port test file of four tests or fewer runs its tests under
    ``torch_parallel_ranks.worker_cpus``: pytest-xdist's ``--dist
    loadfile`` queues such a file behind (or, at four, just ahead of) the
    suite's longest file, ``tests/test_train_zoo.py``, beside which it runs.
"""

import ast
import importlib
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dsmnet_tpu_torch import config
from dsmnet_tpu_torch.ops import _build, conv2d, conv3d, corr, cost_volume, fused_costvol

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import dsmnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dsmnet_tpu_torch.__path__, "dsmnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dsmnet_tpu"))
lazy = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "msgpack", "matplotlib"))
print(len(names), "|".join(names), bad, lazy)
"""


def test_port_imports_no_jax():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stderr
    count, names, bad, lazy = res.stdout.strip().split(" ", 3)
    assert int(count) >= 49, res.stdout  # every module of the package was reached
    for module in ("cli", "data.dataset", "data.transforms", "data.io", "data.paths",
                   "data.check", "train.trainer", "train.state", "utils.benchtime",
                   "utils.evaluate", "utils.viz", "ops.ssim", "ops.gradients",
                   "losses.photometric", "train.color_aug", "train.steps", "parallel",
                   "parallel.context", "parallel.mesh", "parallel.multihost",
                   "parallel.halo"):
        assert f"dsmnet_tpu_torch.{module}" in names.split("|"), module
    assert bad == "[]", f"the port pulled in {bad}"
    assert lazy == "[]", f"importing the port pulled in {lazy}"


_ENTRY_POINTS = {
    "predictor": "from dsmnet_tpu_torch.serve import Predictor\n"
                 "Predictor(maxdisparity=16)",
    "cli_deploy": "from dsmnet_tpu_torch import cli\n"
                  "cli.main(['--mode', 'deploy', '--maxdisparity', '16',"
                  " '--path_left', 'README.md', '--path_right', 'README.md'])",
    "resolve_device": "from dsmnet_tpu_torch import config\nconfig.resolve_device(None)",
    "create_train_state": "from dsmnet_tpu_torch.models import create_model\n"
                          "from dsmnet_tpu_torch.train import create_train_state\n"
                          "create_train_state(create_model('psmnet', 16))",
    "cli_train": "from dsmnet_tpu_torch import cli\n"
                 "cli.main(['--mode', 'train', '--net', 'dispnet', '--maxdisparity', '16',"
                 " '--dataset', 'synthetic'])",
    # a rank of torchrun (a gloo group without a card): cuda:LOCAL_RANK, not the CPU
    "cli_train_rank": "import os\n"
                      "os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',"
                      " MASTER_ADDR='localhost', MASTER_PORT='0')\n"
                      "from dsmnet_tpu_torch import cli\n"
                      "cli.main(['--mode', 'train', '--net', 'dispnet', '--maxdisparity', '16',"
                      " '--dataset', 'synthetic', '--mesh-data', '1'])",
    "trainer": "from dsmnet_tpu_torch.train import TrainConfig, Trainer\n"
               "Trainer(TrainConfig(net='dispnet', maxdisparity=16))",
    "trainer_selfsup": "from dsmnet_tpu_torch.train import TrainConfig, Trainer\n"
                       "Trainer(TrainConfig(net='dispnetcorr', maxdisparity=16,"
                       " loss_name='Cap_ds-mask'))",
}


@pytest.fixture(scope="module")
def entry_point_runs():
    """entry point -> (exit code, stderr) of its call in a fresh interpreter
    with every card hidden; the interpreters run at once."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", "import torch\nassert not torch.cuda.is_available()\n" + code],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, code in _ENTRY_POINTS.items()}
    runs = {}
    try:
        for name, p in procs.items():
            _, stderr = p.communicate(timeout=120)
            runs[name] = (p.returncode, stderr)
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    return runs


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_point_without_cuda_raises(entry, entry_point_runs):
    """device=None means CUDA; with no card the call raises, never falls back."""
    code, stderr = entry_point_runs[entry]
    assert code != 0
    assert "CUDA is not available" in stderr, stderr


# op switch -> (kernel wrapper, module holding its plain version, plain name,
# the shapes of its two operands)
_WRAPPERS = {
    "conv2d": (conv2d.conv2d_k3, conv2d, "conv2d_k3_plain", (1, 4, 8, 32), (3, 3, 32, 32)),
    "conv3d": (conv3d.conv3d_k3, conv3d, "conv3d_plain", (1, 2, 4, 8, 32), (3, 3, 3, 32, 32)),
    "conv3d_s2": (conv3d.conv3d_k3s2, conv3d, "conv3d_s2_plain", (1, 2, 4, 8, 32),
                  (3, 3, 3, 32, 64)),
    "deconv3d": (conv3d.deconv3d_k3s2_kernel, conv3d, "deconv3d_k3s2_plain",
                 (1, 2, 4, 8, 64), (3, 3, 3, 32, 64)),
    "cost_volume": (lambda a, b: cost_volume.cost_volume_kernel(a, b, 4), cost_volume,
                    "concat_cost_volume_reference", (1, 4, 8, 32), (1, 4, 8, 32)),
    "corr1d": (lambda a, b: corr.corr1d_kernel(a, b, 5), corr, "corr1d_plain", (1, 4, 8, 32),
               (1, 4, 8, 32)),
    # the correlation's VJP, which follows the corr1d switch; its cotangent (N,H,W,D)
    "corr1d_vjp": (lambda a, b: corr.corr1d_vjp_kernel(a, b, torch.zeros(1, 4, 8, 5)), corr,
                   "corr1d_vjp", (1, 4, 8, 32), (1, 4, 8, 32)),
    "fused_costvol": (lambda a, b: fused_costvol.cost_volume_conv3x3_kernel(
        a, b, 4, True, torch.float32), fused_costvol, "assemble_plain", (1, 4, 8, 288),
        (1, 4, 8, 288)),
}


@pytest.mark.parametrize("op", sorted(_WRAPPERS))
def test_kernel_wrapper_refuses_cpu_tensor(op, monkeypatch):
    """Forced to the kernel, a wrapper given a CPU tensor raises; it neither
    runs the plain version nor builds, loads or counts a kernel."""
    wrapper, module, plain_name, xs, ks = _WRAPPERS[op]
    calls = []
    monkeypatch.setattr(module, plain_name, lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "build", lambda: calls.append("build"))
    before = dict(_build.LAUNCHES)
    x, k = torch.zeros(xs), torch.zeros(ks)
    with config.implementation("kernel", ops=(op.removesuffix("_vjp"),)):
        with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
            wrapper(x, k)
    assert calls == []
    assert _build.LAUNCHES == before


def _collected(module) -> int:
    """The number of tests pytest collects from ``module``: each test
    function once per combination of its ``parametrize`` marks."""
    count = 0
    for name, fn in vars(module).items():
        if name.startswith("test_") and callable(fn):
            count += math.prod(len(m.args[1]) for m in getattr(fn, "pytestmark", [])
                               if m.name == "parametrize")
    return count


def _enters_worker_cpus(source: str) -> bool:
    """Whether an autouse fixture of the file enters ``worker_cpus``."""
    for node in ast.parse(source).body:
        if isinstance(node, ast.FunctionDef) and any(
                "autouse=True" in ast.unparse(d) for d in node.decorator_list):
            calls = [i.context_expr for w in ast.walk(node) if isinstance(w, ast.With)
                     for i in w.items]
            if any(isinstance(c, ast.Call) and ast.unparse(c.func) == "worker_cpus"
                   for c in calls):
                return True
    return False


def test_small_port_files_run_under_worker_cpus():
    """A heavy test belongs in a file of three tests or fewer, which queues
    behind ``tests/test_train_zoo.py`` and runs beside it: its threads must
    yield that file the CPUs (``worker_cpus``), or the suite's length grows
    with the new test's."""
    small = {}
    for path in sorted(TESTS.glob("test_torch_*.py")):
        n = _collected(importlib.import_module(path.stem))
        assert n > 0, path.name
        if n <= 4:
            small[path.name] = _enters_worker_cpus(path.read_text())
    assert len(small) >= 11, small
    assert all(small.values()), sorted(name for name, ok in small.items() if not ok)
