#!/usr/bin/env python3
"""No module of the package carries a kernel or a branch for one machine:
no Pallas import, no interpreter-mode kernel call, no comparison of the
backend name with "tpu"."""

import ast
import os

import pytest

PKG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sspv_tpu"
)


def _modules():
    out = []
    for root, _dirs, names in os.walk(PKG):
        out += [os.path.relpath(os.path.join(root, n), PKG)
                for n in names if n.endswith(".py")]
    return sorted(out)


def _tree(rel):
    with open(os.path.join(PKG, rel), encoding="utf-8") as f:
        return ast.parse(f.read())


@pytest.mark.parametrize("rel", _modules())
def test_module_has_no_machine_specific_path(rel):
    for node in ast.walk(_tree(rel)):
        if isinstance(node, ast.ImportFrom):
            assert "pallas" not in (node.module or ""), (rel, node.lineno)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                assert "pallas" not in alias.name, (rel, node.lineno)
        elif isinstance(node, ast.Compare):
            consts = [c for c in [node.left, *node.comparators]
                      if isinstance(c, ast.Constant)]
            assert not any(
                isinstance(c.value, str) and c.value.lower() == "tpu"
                for c in consts
            ), (rel, node.lineno)
        elif isinstance(node, ast.keyword):
            assert node.arg != "interpret", (rel, node.lineno)


def test_kernel_modules_and_knobs_are_gone():
    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig

    for gone in ("pallas_view.py", "pallas_kernels.py", "pallas_common.py"):
        assert not os.path.exists(os.path.join(PKG, "ops", gone))
    for knob in ("TPU_USE_PALLAS", "TPU_VIEW_KERNEL", "TPU_VIEW_BLOCK_FRAMES",
                 "TPU_VIEW_ORIENT"):
        assert not hasattr(Config, knob)
    assert "view_kernel" not in FeatureConfig._fields
    assert "use_pallas" not in FeatureConfig._fields
