"""Nothing a run of the benchmark loads is JAX or the JAX package: every
module ``portbench/`` imports, by its source, and ``sys.modules`` after a
CPU import of the harness, the cells' runners, readers, references and
input makers and the port modules they reach, compared by whole
top-level names (the port's package name begins with the JAX
package's)."""

import ast
import json
import subprocess
import sys

from portbench.harness import device as devmod, spec

_PROBE = r"""
import json, sys
from portbench.harness import main, spec, serve_blocks, train_epochs
from portbench import calibrate
from portbench.reference import model, train
import pointnet2_tpu_torch.train, pointnet2_tpu_torch.serving
import pointnet2_tpu_torch.data, pointnet2_tpu_torch.parallel.launch
import pointnet2_tpu_torch.data.procedural_scannet
bench = spec.load_benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
for c in bench["configs"]:
    spec.reference(c["name"])
    spec.inputs(spec.config(bench, c["name"])["data"]["kind"])
print(json.dumps(sorted(sys.modules)))
"""


def test_sources_import_nothing_banned():
    found = set()
    for path in spec.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                found |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                found.add(node.module.split(".")[0])
    assert not found.intersection(devmod.BANNED)
    assert "pointnet2_tpu_torch" in found


def test_loaded_modules_hold_nothing_banned():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pointnet2_tpu_torch" in modules
    assert devmod.banned_modules(modules) == []
    assert devmod.banned_modules(["pointnet2_tpu.ops", "jax.numpy"]) == [
        "jax", "pointnet2_tpu"]
