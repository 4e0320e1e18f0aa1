"""The PyTorch port imports nothing of JAX and nothing of the JAX package.

Every module of `repro_torch` (the runtime's checkpoint, chaos, runners,
data pipeline, campaign launcher, chaos smoke and timing helper, the
distributed runtime's partition, halo exchange, ocean, spawn helper and
ocean cells, the LM configs, models and serving launcher, and the LM
training path's optimizer, gradient compression, training launcher and
`train_lm`, the mesh path's meshes, sharding rules and staged process
group, and the dry run's roofline, kernel formulas and launchers among
them), `chip_smoke.py` (imported, not run) and the
`obs_smoke` entry point
are imported in a fresh interpreter in which a
meta-path finder refuses `jax`, `jaxlib` and `repro`; the test then checks
that none of them reached `sys.modules`.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RUNTIME = ("tree", "checkpoint.checkpoint", "runtime.chaos",
           "runtime.fault_tolerance", "data.pipeline", "launch.sim_campaign",
           "chaos_smoke", "benchmarks.common", "distributed.partition",
           "distributed.halo", "distributed.ocean", "distributed.spawn",
           "launch.ocean_dryrun")
# the LM serving path: configs, models and the serving launcher
LM = ("configs", "configs.base", "configs.archs", "models", "models.layers",
      "models.attention", "models.rwkv", "models.mamba", "models.moe",
      "models.model", "launch.serve")
# the LM training path: the optimizer, the gradient compression, the
# training launcher and the end-to-end training script
TRAIN = ("optim", "optim.adamw", "optim.compression", "launch.train",
         "train_lm")
# the LM mesh path: the meshes, the sharding rules and the ranks' group
MESH = ("launch.mesh", "models.sharding", "distributed.staged")
# the dry runs: the roofline, the kernels' formulas and the launchers
DRYRUN = ("roofline", "roofline.analysis", "roofline.rederive",
          "roofline.kernels", "launch.ocean_dryrun", "launch.lm_dryrun",
          "launch.dryrun")

SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.util, pkgutil, sys

    BANNED = ("jax", "jaxlib", "repro")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1] + "/src")

    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    importlib.import_module("repro_torch.obs.diagnostics")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", sys.argv[1] + "/chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    assert not leaked, leaked
    print(" ".join(names))
    print(len(names))
""")


def test_port_imports_no_jax_and_no_repro():
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    n, names = int(lines[-1]), set(lines[-2].split())
    # every module of the package, obs and obs_smoke included
    assert n >= 35, res.stdout
    assert names >= {f"repro_torch.{m}" for m in RUNTIME + LM + TRAIN + MESH + DRYRUN}, \
        res.stdout


def test_finder_refuses_jax():
    """The guard itself: a refused import fails in the same set-up."""
    probe = SCRIPT.split("sys.path.insert")[0] + "import jax\n"
    res = subprocess.run([sys.executable, "-c", probe, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "refused import of jax" in res.stderr
