"""Nothing the benchmark runs imports JAX or the JAX package: a scan of
every file of ``benchmark/`` (the whole top-level name compared), and the
check a run makes of its own loaded modules."""

import ast

from benchmark.harness import isolation, spec


def imported_top_levels(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {isolation.top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(isolation.top_level(node.module))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(isolation.top_level(node.args[0].value))
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = imported_top_levels(path) & set(isolation.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_port_is_allowed_the_jax_package_is_not():
    assert isolation.forbidden_loaded(
        ["kubeoperator_tpu_torch", "kubeoperator_tpu_torch.workloads.vit",
         "torch", "benchmark.harness"]) == []
    assert isolation.forbidden_loaded(
        ["kubeoperator_tpu.workloads.train", "jax.numpy", "flax"]) == [
        "flax", "jax", "kubeoperator_tpu"]
    assert isolation.forbidden_loaded(["jaxtyping", "flaxen"]) == []


def test_the_port_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.harness import driver, isolation; "
            "import benchmark.configs.resnet50, benchmark.configs.vit_b16; "
            "from kubeoperator_tpu_torch.workloads import train, vit; "
            "from kubeoperator_tpu_torch.train import launch; "
            "print(isolation.forbidden_loaded())" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
