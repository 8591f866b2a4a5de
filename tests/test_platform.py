"""The platform module, the compile-cache rule and chip_smoke.py's refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from waldboost_tpu import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_interprets_kernels():
    assert platform.platform() == "cpu"
    assert platform.kernel_interpret() is True
    assert platform.kernel_interpret("cpu") is True


def test_gpu_compiles_kernels():
    assert platform.kernel_interpret("gpu") is False


@pytest.mark.parametrize("name", ["rocm", "metal", "unknown"])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="no kernel route"):
        platform.kernel_interpret(name)


def _run(code, env_extra=None, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_rule(tmp_path):
    """JAX_COMPILATION_CACHE_DIR names the cache when set; otherwise the
    cache is .jax_cache in the checkout."""
    code = ("import jax, waldboost_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == os.path.join(ROOT,
                                                                ".jax_cache")


def _assert_refused(out):
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    _assert_refused(out)
    assert "no GPU" in out.stderr


def test_chip_smoke_refuses_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails (no device here, and no program beside it)."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    _assert_refused(out)


def test_platform_is_decided_in_one_module():
    """Only platform.py asks JAX for the backend, and kernels import only
    the Triton route of Pallas."""
    pkg = os.path.join(ROOT, "waldboost_tpu")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert "default_backend()" not in src or \
                    f == "platform.py", f
                for line in src.splitlines():
                    if "experimental.pallas import" in line:
                        assert line.split("import")[1].strip() in (
                            "pallas as pl", "triton as plgpu"), (f, line)
