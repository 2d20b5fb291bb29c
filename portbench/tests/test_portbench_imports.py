"""What the benchmark loads: nothing of JAX or of the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), the reference nothing of the program, and no measurement path
that falls back to the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
JAX_SIDE = {"jax", "jaxlib", "flax", "metagenome_vector_sketches_tpu"}


def _python(code: str, cwd: str = ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "metagenome_vector_sketches_tpu_torch_x",
                        sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("workload", ["shard_i32_cold", "search_i32_b64"])
def test_a_run_loads_no_jax(tiny, workload):
    bench, base = tiny
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        f"bench = json.loads({json.dumps(json.dumps(bench))})\n"
        f"res = run.run_cell(bench, {workload!r}, 3, 0.3, False,\n"
        f"                   device='cpu', root='/', base={base!r})\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': res['correct'], 'tops': tops}))\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "metagenome_vector_sketches_tpu_torch" in out["tops"]
    assert not JAX_SIDE & set(out["tops"])
    assert not {"benchmarks", "bench", "bench_data"} & set(out["tops"])


def test_the_reference_imports_nothing_of_the_program():
    p = _python("import sys\n"
                "from portbench.reference import exact, search, shardfmt\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not (JAX_SIDE | {"metagenome_vector_sketches_tpu_torch"}) & tops


def test_no_source_reads_the_jax_benchmarks():
    for dirpath, _, files in os.walk(PKG):
        if os.path.basename(dirpath) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                for word in ("benchmarks/", "bench.py", "import jax",
                             "bench_data"):
                    assert word not in text, (f, word)


def test_without_a_card_the_run_fails_and_prints_no_result(monkeypatch,
                                                            capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "shard_i32_cold", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "shard_i32_cold", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_module_loaded_by_the_check_withholds_the_result(tiny, monkeypatch,
                                                           capsys):
    """The look for JAX comes after the check: a check that loads a module
    named ``jax`` leaves the run with no result and a non-zero exit."""
    import types

    import torch

    from portbench import spec
    bench, base = tiny
    real_driver = spec.driver

    def driver(name, base=spec.HERE):
        cls = real_driver(name, base)

        class LoadsJax(cls):
            def check(self, calls, precision="exact"):
                monkeypatch.setitem(sys.modules, "jax",
                                    types.ModuleType("jax"))
                return super().check(calls, precision)
        return LoadsJax

    monkeypatch.setattr(spec, "driver", driver)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real_run = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda _bench, *a, **kw: real_run(
        bench, *a, device="cpu", root="/", base=base))
    rc = run.main(["--workload", "shard_i32_cold", "--seed", "1",
                   "--seconds", "0.3", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "jax" in out.err.splitlines()[-1]
