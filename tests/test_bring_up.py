"""What keeps the program honest about the device it runs on: where the
compile cache lives, no Pallas kernels, no silent platform switch, the
GPU smoke test refusing to run elsewhere, and no per-device timing rows
for a machine the program does not run on."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from rub_mimo_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_in_checkout(monkeypatch):
    from rub_mimo_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_no_module_imports_pallas():
    bad = []
    for f in (REPO / "rub_mimo_tpu").rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if "pallas" in n]
    assert not bad, bad


def test_dryrun_multichip_raises_on_too_few_devices():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as graft

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match="needs"):
        graft.dryrun_multichip(n)
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == n - 1


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_a_non_gpu_platform():
    p = _run_smoke(REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run_smoke(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_impl_table_has_no_foreign_device_rows():
    from rub_mimo_tpu.utils import impl_select

    table = json.loads(Path(impl_select.table_path()).read_text())
    assert set(table) <= {"_meta", "cpu", "gpu"}
    for backend, points in table.items():
        if backend == "_meta":
            continue
        for point, impls in points.items():
            assert set(impls) <= set(impl_select.IMPLS[point]), point
