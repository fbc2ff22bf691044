"""The port exports what the reference exports from the modules it has
ported: every name that ``paddle_tpu``, ``paddle_tpu.models``,
``paddle_tpu.serving`` and ``paddle_tpu.utils`` re-export, whose
defining module has a counterpart in ``paddle_tpu_torch`` that defines
it, resolves at the same place in the port (so code written against the
reference does not meet an ``ImportError``), and the port's
``serving.__all__`` lists what the reference's lists.

The reference's ``__init__.py`` files are read with ``ast``: nothing of
the JAX package is imported here.
"""
import ast
import importlib
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("", ".models", ".serving", ".utils")


def _port_name(ref_module):
    return "paddle_tpu_torch" + ref_module[len("paddle_tpu"):]


def _has_module(name):
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        return False


def _reference_exports(pkg):
    """[(defining module, name, exported name)] of the reference package's
    ``__init__.py``: its ``from X import a [as b]`` statements, and the
    subpackages its module ``__getattr__`` loads lazily."""
    path = ROOT / "paddle_tpu" / pkg.lstrip(".").replace(".", "/") / \
        "__init__.py"
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.split(".")[0] == "paddle_tpu":
            out += [(node.module, a.name, a.asname or a.name)
                    for a in node.names if a.name != "*"]
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and isinstance(
                        sub.comparators[0], ast.Tuple):
                    out += [("paddle_tpu", e.value, e.value)
                            for e in sub.comparators[0].elts]
    return out


def _ported(module, name):
    """Whether the port's counterpart of ``module`` defines ``name`` (a
    function, class or constant there, or a submodule of it)."""
    port = _port_name(module)
    if _has_module(f"{port}.{name}"):
        return True
    if not _has_module(port):
        return False
    return hasattr(importlib.import_module(port), name)


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "root")
def test_reference_exports_of_ported_modules_resolve(pkg):
    port = importlib.import_module("paddle_tpu_torch" + pkg)
    checked, missing = 0, []
    for module, name, exported in _reference_exports(pkg):
        if not _ported(module, name):
            continue
        checked += 1
        if not hasattr(port, exported):
            missing.append(f"{exported} (from {module})")
    assert checked, pkg
    assert not missing, f"paddle_tpu_torch{pkg} lacks {missing}"


def test_the_faults_the_roadmap_named_are_repaired():
    """The names that raised ImportError before: the seven models, the
    serving names, the profiler, ``save`` and ``load``."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import models, serving, utils
    for name in ("LlamaModel", "MixtralConfig", "MixtralForCausalLM",
                 "MoEConfig", "MoEForCausalLM", "Qwen2MoeConfig",
                 "Qwen2MoeForCausalLM"):
        assert hasattr(models, name), name
    for name in ("AdapterStore", "TokenMaskAutomaton", "json_schema_regex"):
        assert name in serving.__all__, name
    for name in ("PagedKVCache", "METRICS"):
        assert hasattr(serving, name), name
    assert callable(utils.Profiler)
    from paddle_tpu_torch.train import checkpoint
    assert ptt.save is checkpoint.save and ptt.load is checkpoint.load


def test_serving_all_lists_the_reference_s():
    tree = ast.parse((ROOT / "paddle_tpu/serving/__init__.py").read_text())
    ref_all = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "__all__")
    from paddle_tpu_torch import serving
    assert set(ref_all) <= set(serving.__all__)
    for name in serving.__all__:
        assert hasattr(serving, name), name


def test_encoder_classes_are_exported():
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import auto
    for mt in ("bert", "roberta", "ernie", "electra", "layoutlm",
               "distilbert", "albert", "ernie_m"):
        entry = auto.AUTO_REGISTRY[mt]
        for cls in (entry.config_cls, entry.model_cls):
            assert getattr(models, cls.__name__) is cls, (mt, cls)
