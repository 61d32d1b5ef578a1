"""Nothing the harness or the reference runs imports JAX or the JAX
package: top-level module names compared whole (`pointseg_torch` is not
`pointseg`)."""

import ast
import json
import subprocess
import sys

from portbench.tests.conftest import REPO, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pointseg"}


def test_sources_import_none():
    for path in (REPO / "portbench").rglob("*.py"):
        if ".cache" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_a_run_loads_none():
    code = (
        "import sys, json, runpy\n"
        "sys.argv = ['portbench/run.py', '--workload', 'pointnet2_ssg.b128-store', '--seed', '5',"
        " '--seconds', '1', '--trace', '1', '--dry-run', " + repr(json.dumps(TINY)) + "]\n"
        "try:\n    runpy.run_path('portbench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n    assert not e.code, e.code\n"
        "import portbench.tests.readings, portbench.tests.set_limits, portbench.tests.faults\n"
        "print('MODULES', json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("MODULES ")][-1]
    loaded = set(json.loads(line[len("MODULES "):]))
    assert "pointseg_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN
