"""The port imports torch and never jax: every module of
fastertransformer4codefuse_tpu_torch, and chip_smoke.py, import in a fresh
interpreter with no jax module loaded."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import fastertransformer4codefuse_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not any(m.startswith("fastertransformer4codefuse_tpu.") for m in sys.modules)
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    # every module was imported: 50 with the checkpoint-to-CLI path (ckpt/loader,
    # ckpt/cutlass_interop, native, api/cli, api/wordlist_csv) and speculative
    # decoding (engine/speculative, engine/spec_pool); 56 with utils/ (logger,
    # profiling, debug) and ckpt/calibrate, ckpt/smoothquant; 64 with the
    # decoder families (ops/moe and the seven ckpt/convert_* converters)
    assert int(out.stdout.strip().splitlines()[-1]) >= 64
