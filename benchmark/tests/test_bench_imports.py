"""No module of benchmark/ imports jax, jaxlib or the JAX package tpu_bvh; the
reference's modules import nothing of the program either. Names are compared
whole by their top level (the part before the first dot), so the port's
`tpu_bvh_torch` is not the JAX package `tpu_bvh`."""
import ast
import glob
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "tpu_bvh"}
REFERENCE_ALSO = {"tpu_bvh_torch"}


def _imported(path):
    """Top-level names of every module a file imports, at any depth of its
    code, and every string handed to importlib.import_module."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _modules(sub=""):
    return sorted(glob.glob(os.path.join(HERE, sub, "**", "*.py"), recursive=True))


def test_bench_no_module_imports_jax_or_the_jax_package():
    files = _modules()
    assert len(files) > 20
    for path in files:
        assert not (_imported(path) & FORBIDDEN), path


def test_bench_reference_imports_nothing_of_the_program():
    files = _modules("reference")
    assert files
    for path in files:
        assert not (_imported(path) & (FORBIDDEN | REFERENCE_ALSO)), path


def _entries(value, where=()):
    """Every "module:attribute" string in a data file, with its key path."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _entries(v, where + (k,))
    elif isinstance(value, str) and ":" in value and "." in value.split(":")[0] \
            and " " not in value:
        yield where, value


def _data_files():
    return glob.glob(os.path.join(HERE, "configs", "*.json")) + \
        glob.glob(os.path.join(HERE, "traffic", "*.json"))


def test_bench_entries_named_in_data_are_the_port():
    """The entries that configurations and mixes name by string are the
    port's or the harness's own, never the JAX package's."""
    import json

    for path in _data_files():
        for key, value in _entries(json.load(open(path))):
            assert value.split(".")[0] in ("tpu_bvh_torch", "benchmark"), (path, key)


def test_bench_entries_named_in_data_resolve():
    """Each configuration names its program entry, scene and reference; each
    mix its steps, check and control (and inputs, or null): all resolve."""
    import json
    import sys

    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark import entry

    for path in _data_files():
        data = json.load(open(path))
        keys = (("entry",), ("scene",), ("reference",)) if "configs" in path else \
            (("steps",), ("check", "entry"), ("control",))
        named = dict(_entries(data))
        for key in keys:
            assert key in named, (path, key)
        for key, value in named.items():
            assert callable(entry(value)), (path, key)


def test_bench_whole_name_comparison():
    assert "tpu_bvh_torch.models".split(".")[0] not in FORBIDDEN
    assert "tpu_bvh.models".split(".")[0] in FORBIDDEN
