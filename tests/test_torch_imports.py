"""The port's import rule and device rule.

paimon_tpu_torch and chip_smoke.py import torch, numpy and the standard
library only: never jax, paimon_tpu, pyarrow or zstandard. tests/conftest.py
imports jax into this process, so the closure is checked in a child
process; an AST scan covers every source file. The default device is CUDA,
and without one the entry points raise instead of running on the CPU.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paimon_tpu", "pyarrow", "zstandard")
SOURCES = sorted((REPO / "paimon_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_closure_in_a_child_process():
    modules = sorted(
        "paimon_tpu_torch." + ".".join(p.relative_to(REPO / "paimon_tpu_torch").with_suffix("").parts)
        for p in (REPO / "paimon_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        "import paimon_tpu_torch, paimon_tpu_torch.catalog\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


@pytest.mark.parametrize("module", ["data/predicate.py", "table/delete.py", "core/deletionvectors.py"])
def test_row_level_delete_modules_are_scanned(module):
    """The predicate, DELETE and deletion-vector modules are in the scanned
    sources (and so in the child process's import closure)."""
    path = REPO / "paimon_tpu_torch" / module
    assert path in SOURCES
    test_no_forbidden_import_in_source(path)


@pytest.mark.parametrize("module", ["table/stream.py", "table/enumerator.py", "table/rollback.py", "table/branch.py"])
def test_history_modules_are_scanned(module):
    """The streaming reader, enumerator, rollback and branch modules are in
    the scanned sources (and so in the child process's import closure)."""
    path = REPO / "paimon_tpu_torch" / module
    assert path in SOURCES
    test_no_forbidden_import_in_source(path)


@pytest.mark.parametrize("module", ["core/append.py", "table/crosspartition.py", "table/write.py", "core/store.py"])
def test_write_surface_modules_are_scanned(module):
    """The append writer, the cross-partition writer and the modules that
    route to them are in the scanned sources (and so in the child
    process's import closure)."""
    path = REPO / "paimon_tpu_torch" / module
    assert path in SOURCES
    test_no_forbidden_import_in_source(path)


def _port_options() -> list:
    from paimon_tpu_torch.options import ConfigOption, CoreOptions

    return sorted((name, o) for name, o in vars(CoreOptions).items() if isinstance(o, ConfigOption))


@pytest.mark.parametrize("name, option", _port_options(), ids=lambda x: x if isinstance(x, str) else "")
def test_option_has_the_jax_key_and_default(name, option):
    """Options persist in the table schema as strings, so every option of
    the port's CoreOptions (those the write surface added among them:
    dynamic-partition-overwrite, cross-partition-upsert.*,
    compaction.min.file-num, write-buffer-spillable,
    write-buffer-for-append) is the JAX package's key, with its default
    and its fallback keys."""
    from paimon_tpu.options import ConfigOption as JaxOption
    from paimon_tpu.options import CoreOptions as JaxCoreOptions

    by_key = {o.key: o for o in vars(JaxCoreOptions).values() if isinstance(o, JaxOption)}
    assert option.key in by_key, f"{name}: the JAX package has no option {option.key!r}"
    jax = by_key[option.key]
    assert option.default == jax.default
    assert tuple(option.fallback_keys) == tuple(jax.fallback_keys or ())


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    from paimon_tpu_torch.catalog import FileSystemCatalog

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FileSystemCatalog(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        FileSystemCatalog(str(tmp_path), device="cuda")
    assert FileSystemCatalog(str(tmp_path), device="cpu").device.type == "cpu"


def test_load_table_default_device_without_cuda_raises(monkeypatch, tmp_path):
    import paimon_tpu_torch as tt
    from paimon_tpu_torch.catalog import FileSystemCatalog
    from paimon_tpu_torch.table import load_table

    table = FileSystemCatalog(str(tmp_path), device="cpu").create_table(
        "db.t", tt.RowType.of(("id", tt.BIGINT(False))), primary_keys=["id"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_table(table.path)
    assert load_table(table.path, device="cpu").device.type == "cpu"


def test_merge_ops_default_device_without_cuda_raises(monkeypatch):
    import numpy as np

    from paimon_tpu_torch.ops import merge

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lanes = np.array([[3], [1], [3], [2]], dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        merge.deduplicate_select(lanes)
    assert merge.deduplicate_select(lanes, device="cpu").tolist() == [1, 3, 2]


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script-alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and in
    a directory holding nothing of the repo but the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
